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
from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d
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


# --- the f32 stem: K4F and K5F's arithmetic on the CPU ---------------------------

def _taps_conv(x, wt, bias=None):
    """A 3x3 'same' conv of NHWC ``x`` through weights laid out (9 taps, in,
    out), as K4F/K5F's conv1 kernel applies them: out[p] = sum over taps t
    of x[p + (t // 3 - 1, t % 3 - 1)] @ wt[t], zero outside the page."""
    n, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    out = sum(xp[:, t // 3: t // 3 + h, t % 3: t % 3 + w] @ wt[t] for t in range(9))
    return out if bias is None else out + bias


def _f64_stem_weights(seed):
    """Stem weights with f32 values (what the kernels read), in f64."""
    return [(_oihw(a) if a.ndim == 4 else torch.from_numpy(a)).double()
            for a in _stem_weights(seed)]


def test_f32_conv1_taps_are_the_forward_and_its_dgrad():
    """K4F/K5F's re-laid conv1 weights (``_f32_conv1_taps``), applied as the
    kernel applies them: w1f gives conv1, w1b its dgrad. f64, within 1e-12."""
    _, _, w1, _ = _f64_stem_weights(11)
    w1f, w1b = (t.double() for t in kvs._f32_conv1_taps(w1))
    assert w1f.shape == w1b.shape == (9, 64, 64)
    x = torch.randn((2, 6, 5, 64), dtype=torch.float64, requires_grad=True)
    y = conv2d(x, w1, padding=1)
    torch.testing.assert_close(_taps_conv(x, w1f), y, rtol=1e-12, atol=1e-12)
    g = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, g)
    torch.testing.assert_close(_taps_conv(g, w1b), dx, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,h,w", [(2, 16, 24), (1, 18, 26)])
def test_k4f_and_k5f_passes_compose_to_the_plain_stem(m, h, w):
    """K4F's four passes (conv0 from its (64, 27) rows; conv1 through w1f
    with the window's cotangent to its first maximum where z1 > 0; the
    dgrad through w1b where a0 > 0; conv0's dgrad) and K5F's pooled conv1,
    in torch on the wrapper's own re-laid weights, against the plain
    versions, all in f64: within 1e-10, and within 1e-7 relative for dx,
    which ``stem_dx_reference`` returns rounded to f32."""
    w0, b0, w1, b1 = _f64_stem_weights(12)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((m, h, w, 3)))
    g = torch.from_numpy(rng.standard_normal((m, h // 2, w // 2, 64)))
    w0t = kvs._w0_rows(w0, torch.float32).double()  # (64 out, 27), k = tap * 3 + in
    w1f, w1b = (t.double() for t in kvs._f32_conv1_taps(w1))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, t // 3: t // 3 + h, t % 3: t % 3 + w] for t in range(9)], dim=-1)
    a0 = torch.relu(cols @ w0t.T + b0)                                     # pass 1
    z1 = _taps_conv(a0, w1f, b1)                                           # pass 2

    def windows(t):  # (m, h, w, 64) -> (m, h/2, w/2, 4, 64), row-major in the window
        return t.reshape(m, h // 2, 2, w // 2, 2, 64).permute(0, 1, 3, 2, 4, 5).reshape(
            m, h // 2, w // 2, 4, 64)

    first = torch.nn.functional.one_hot(windows(torch.relu(z1)).argmax(dim=3), 4).permute(
        0, 1, 2, 4, 3)
    gz1 = (first * (windows(z1) > 0) * g[:, :, :, None, :]).reshape(
        m, h // 2, w // 2, 2, 2, 64).permute(0, 1, 3, 2, 4, 5).reshape(m, h, w, 64)
    gz0 = torch.where(a0 > 0, _taps_conv(gz1, w1b), 0.0)                   # pass 3
    gp = torch.nn.functional.pad(gz0, (0, 0, 1, 1, 1, 1))
    dx = sum(gp[:, 2 - t // 3: 2 - t // 3 + h, 2 - t % 3: 2 - t % 3 + w] @ w0t[:, 3 * t: 3 * t + 3]
             for t in range(9))                                            # pass 4
    torch.testing.assert_close(dx, kvs.stem_dx_reference(x, g, w0, b0, w1, b1).double(),
                               rtol=1e-7, atol=1e-10)
    z0 = torch.from_numpy(rng.standard_normal((m, h, w, 64)))
    pooled = windows(torch.relu(_taps_conv(torch.relu(z0), w1f, b1))).amax(dim=3)  # K5F
    torch.testing.assert_close(pooled, kvs.stem_pool_reference(z0, w1, b1), rtol=1e-10,
                               atol=1e-10)


def test_stem_wrappers_route_f32_to_k4f_and_k5f():
    """On the CPU both dtypes take the plain version, in the input's dtype;
    the f32 launchers refuse a tensor that is not a float32 CUDA one."""
    w0, b0, w1, b1 = (_oihw(a) if a.ndim == 4 else torch.from_numpy(a) for a in _stem_weights(14))
    x, g = torch.rand((1, 16, 16, 3)), torch.randn((1, 8, 8, 64))
    z0 = torch.randn((1, 16, 16, 64))
    assert kvs.stem_dx(x, g, w0, b0, w1, b1).dtype == torch.float32
    assert kvs.stem_pool(z0, w1, b1).dtype == torch.float32
    with pytest.raises(ValueError, match="float32 CUDA"):
        kvs._launch_k4f(x, g, w0, b0, w1, b1)
    with pytest.raises(ValueError, match="float32 CUDA"):
        kvs._launch_k5f(z0, w1, b1)


def test_inpaint_cli_trains_in_f32_with_the_fused_stem(tmp_path, monkeypatch):
    """``run_inpaint --no-bf16 --fused-stem`` at a tiny size on the CPU: the
    stem's dx and its pooled forward run in float32 (on the card: K4F and
    K5F), the terms finite."""
    import json

    from text_segmentation_image_inpainting_tpu_torch.train import run_inpaint

    seen = []
    for name in ("stem_dx", "stem_pool"):
        fn = getattr(kvs, name)
        monkeypatch.setattr(kvs, name, lambda t, *a, _fn=fn, _n=name: (
            seen.append((_n, t.dtype)), _fn(t, *a))[1])
    monkeypatch.chdir(tmp_path)
    state = run_inpaint.main(["--steps", "2", "--batch-size", "2", "--image-size", "32",
                              "--depth", "3", "--log-every", "1", "--val-batches", "1",
                              "--no-bf16", "--fused-stem", "--device", "cpu",
                              "--ckpt-dir", str(tmp_path / "c")])
    assert state.step == 2
    assert sorted(set(seen)) == [("stem_dx", torch.float32), ("stem_pool", torch.float32)]
    with open("logs/inpaint.jsonl") as f:
        logs = [json.loads(line) for line in f]
    assert [r["step"] for r in logs] == [1, 2]
    assert all(np.isfinite(r[k]) for r in logs for k in ("total", "perceptual", "style_out"))
