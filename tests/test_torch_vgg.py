"""The port's frozen VGG16 and its stem against the JAX package's, on the CPU.

JAX runs its stock trunk (``fused_stem=False``): the compiled stem kernel
has no CPU mode and its interpret mode takes minutes. The port's fused
path on the CPU takes the stem's plain versions (``stem_dx_reference``,
``stem_pool_reference``), which are what K4 and K5 are held to on the
card. float32, rtol 1e-4 / atol 1e-5 (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_segmentation_image_inpainting_tpu.compat.torch_import import import_vgg16_features
from text_segmentation_image_inpainting_tpu.models.vgg import VGG16Features as JaxVGG
from text_segmentation_image_inpainting_tpu.ops.pallas import vgg_stem as jstem
from text_segmentation_image_inpainting_tpu.ops.pallas import vgg_stem_bwd as jstem_bwd
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import (
    load_state_dict,
    vgg16_features_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.models import vgg as tvgg
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
from tests.test_torch_bridge import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


RTOL, ATOL = 1e-4, 1e-5


def _jax_vgg(num_taps=3, hw=(16, 32), seed=0):
    model = JaxVGG(num_taps=num_taps)
    variables = jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, *hw, 3)))
    # random biases, so every bias path does real work
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda v: np.asarray(v), variables["params"])
    for layer in params.values():
        layer["bias"] = (0.1 * rng.standard_normal(layer["bias"].shape)).astype(np.float32)
    return model, {"params": params}


def _port_vgg(variables, **kw):
    model = tvgg.VGG16Features(**kw)
    load_state_dict(model, vgg16_features_state_dict(variables))
    return model


@pytest.fixture(scope="module")
def vgg():
    model, variables = _jax_vgg()
    x = np.random.default_rng(1).uniform(0, 1, (2, 16, 32, 3)).astype(np.float32)
    return model, variables, _port_vgg(variables), x


def test_bridge_names_are_torchvisions_and_round_trip(vgg):
    """flax conv{j} -> torchvision features.{i}, and back through the JAX
    package's own torchvision importer to the same variables."""
    _, variables, port, _ = vgg
    sd = vgg16_features_state_dict(variables)
    assert sorted(sd) == sorted(port.state_dict())
    assert {k.split(".")[1] for k in sd} == {"0", "2", "5", "7", "10", "12", "14"}
    back = import_vgg16_features(sd)
    for name, layer in variables["params"].items():
        for k, v in layer.items():
            np.testing.assert_array_equal(np.asarray(back["params"][name][k]), v)


def test_taps_match_jax(vgg):
    model, variables, port, x = vgg
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert [tuple(t.shape) for t in got] == [(2, 8, 16, 64), (2, 4, 8, 128), (2, 2, 4, 256)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_weights_are_frozen(vgg):
    assert not any(p.requires_grad for p in vgg[2].parameters())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_stem_forward_equals_stock(dtype):
    _, variables = _jax_vgg()
    port = _port_vgg(variables, dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 16, 32, 3)).astype(np.float32))
    ref = port(x)
    for need_grad in (False, True):  # K5's plain version, then the K4 Function's forward
        got = tvgg.apply_vgg_features(port, x.clone().requires_grad_(need_grad), fused_stem=True)
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype == dtype and torch.equal(a, b.detach())


def test_fused_stem_gradient_matches_jax(vgg):
    """d(sum_taps <tap, r>)/dx through the port's fused stem (its CPU
    backward is stem_dx_reference) against JAX's stock autodiff."""
    model, variables, port, x = vgg
    rng = np.random.default_rng(3)
    rs = [rng.standard_normal(s).astype(np.float32)
          for s in ((2, 8, 16, 64), (2, 4, 8, 128), (2, 2, 4, 256))]

    def loss(x):
        return sum(jnp.vdot(t, r) for t, r in zip(model.apply(variables, x), rs))

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    taps = tvgg.apply_vgg_features(port, xt, fused_stem=True)
    sum((t * torch.from_numpy(r)).sum() for t, r in zip(taps, rs)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=RTOL, atol=ATOL)


def test_geometry_fallback(vgg, monkeypatch):
    """W % 16 != 0: the stock path runs, the stem Function never does."""
    _, _, port, _ = vgg
    monkeypatch.setattr(tvgg, "vgg_stem_frozen", lambda *a: pytest.fail("fused stem used"))
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (1, 16, 24, 3)).astype(np.float32))
    for a, b in zip(port(x), tvgg.apply_vgg_features(port, x, fused_stem=True)):
        assert torch.equal(a, b)


def _stem_weights(seed):
    rng = np.random.default_rng(seed)
    w0 = (0.3 * rng.standard_normal((3, 3, 3, 64))).astype(np.float32)
    w1 = (0.06 * rng.standard_normal((3, 3, 64, 64))).astype(np.float32)
    b0 = (0.1 * rng.standard_normal(64)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(64)).astype(np.float32)
    return w0, b0, w1, b1


def _oihw(w):
    return torch.from_numpy(w.transpose(3, 2, 0, 1).copy())


def test_stem_dx_reference_matches_jax_vjp():
    """K4's plain version against jax.vjp of ``stem_forward_xla`` (f32)."""
    w0, b0, w1, b1 = _stem_weights(5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 32, 3)).astype(np.float32)
    g = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jstem_bwd.stem_forward_xla(x, w0, b0, w1, b1, jnp.float32),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = kvs.stem_dx(torch.from_numpy(x), torch.from_numpy(g), _oihw(w0), torch.from_numpy(b0),
                      _oihw(w1), torch.from_numpy(b1))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_stem_pool_reference_matches_jax():
    _, _, w1, b1 = _stem_weights(7)
    z0 = np.random.default_rng(8).standard_normal((2, 16, 32, 64)).astype(np.float32)
    want = jstem.stem_pool_reference(jnp.asarray(z0), jnp.asarray(w1), jnp.asarray(b1))
    got = kvs.stem_pool(torch.from_numpy(z0), _oihw(w1), torch.from_numpy(b1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_stem_wrappers_refuse_cpu_tensors_for_the_kernels():
    w0, b0, w1, b1 = _stem_weights(9)
    x = torch.zeros((1, 16, 16, 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kvs._launch_k4(x, torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16), _oihw(w0),
                       torch.from_numpy(b0), _oihw(w1), torch.from_numpy(b1))
    with pytest.raises(ValueError, match="CUDA"):
        kvs._launch_k5(torch.zeros((1, 16, 16, 64), dtype=torch.bfloat16), _oihw(w1),
                       torch.from_numpy(b1))


def test_frozen_stem_refuses_trainable_weights():
    w0, b0, w1, b1 = _stem_weights(10)
    with pytest.raises(ValueError, match="frozen"):
        kvs.vgg_stem_frozen(torch.zeros((1, 16, 16, 3)), _oihw(w0).requires_grad_(),
                            torch.from_numpy(b0), _oihw(w1), torch.from_numpy(b1), torch.float32)


def test_loads_a_torchvision_state_dict():
    """A fabricated torchvision vgg16 state_dict (every features layer and
    the classifier): the trunk takes its 7 convs and ignores the rest;
    a missing layer is an error."""
    gen = torch.Generator().manual_seed(0)
    sd, c = {}, 3
    for i, v in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                    (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)):
        sd[f"features.{i}.weight"] = torch.randn((v, c, 3, 3), generator=gen)
        sd[f"features.{i}.bias"] = torch.randn((v,), generator=gen)
        c = v
    sd["classifier.0.weight"] = torch.randn((8, 8), generator=gen)
    model = tvgg.VGG16Features()
    tvgg.load_vgg16_state_dict(model, sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    del sd["features.14.bias"]
    with pytest.raises(KeyError, match="features.14.bias"):
        tvgg.load_vgg16_state_dict(tvgg.VGG16Features(), sd)


def _old_normalize(x):
    """The per-call constants the module built before: two host-to-device
    copies a call on CUDA."""
    mean = torch.tensor(tvgg.IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(tvgg.IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_normalize_constants_live_on_the_module(vgg, dtype, monkeypatch):
    """The ImageNet constants are buffers built once (f64, outside the
    state_dict) and rounded once to x's dtype: the normalised input and
    the loss terms are bit-equal to the per-call constants'."""
    from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
        InpaintLossConfig,
        inpainting_loss,
    )

    _, variables, _, x = vgg
    model = _port_vgg(variables, dtype=dtype)
    if dtype == torch.float64:
        model = model.double()
    assert not any("imagenet" in k for k in model.state_dict())
    xt = torch.from_numpy(x).to(dtype)
    assert torch.equal(model.normalize_input(xt), _old_normalize(xt))
    rng = np.random.default_rng(7)
    gt = torch.from_numpy(rng.uniform(0, 1, x.shape).astype(np.float32)).to(dtype)
    mask = torch.from_numpy((rng.random((*x.shape[:3], 1)) > 0.3).astype(np.float32)).to(dtype)
    cfg = InpaintLossConfig(vgg_dtype=str(dtype).split(".")[1])
    _, new = inpainting_loss(xt, gt, mask, model, config=cfg)
    monkeypatch.setattr(model, "normalize_input", _old_normalize)
    _, old = inpainting_loss(xt, gt, mask, model, config=cfg)
    for k in old:
        assert torch.equal(new[k], old[k]), k
