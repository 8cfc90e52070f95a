"""The float32 path of the partial convolution (the kernels' f32 form on the
card) against JAX's partial conv in float32 through its XLA twin
(``ops/partial_conv.py::_partial_conv2d_xla``), on the CPU.

JAX's Pallas kernels take x's dtype as it comes, so an f32 U-Net, an f32
``TextRemovalPipeline`` and ``run_inpaint --no-bf16`` compute in f32 there;
the port's CUDA wrapper runs its f32 form (``pconv_f32`` forward,
``pconv_k3_prep``/``pconv_k3_mask`` around an f32 ``convolution_backward``
backward), held on the card to the plain version this file holds to JAX.
On the CPU ``partial_conv2d_fused`` is that plain version:
``PartialConvFunction``'s forward and backward at the U-Net's layer kinds
(two mask groups, Cout >= 8 and the RGB head's 3, padding (1, 1) and an
H-sharded layer's (0, 1)) against the XLA twin and its ``jax.vjp`` at
``tests/test_torch_ops.py``'s float32 bounds (rtol 1e-3 / atol 1e-4), M'
exact; then the f32 U-Net forward and the f32 inpaint step, their
stride-1 layers through ``partial_conv2d_fused`` in f32 (counted), against
JAX at ``tests/test_torch_train_step.py``'s bounds. No f32 kernel launch
is counted on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import jax_unet_variables, one_torch_thread, port_unet
from tests.test_torch_vgg import _jax_vgg, _port_vgg
from text_segmentation_image_inpainting_tpu.losses.inpainting import (
    InpaintLossConfig as JaxLossConfig,
)
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.ops import partial_conv as jpc
from text_segmentation_image_inpainting_tpu.train import config as jconfig
from text_segmentation_image_inpainting_tpu.train.inpaint import (
    make_inpaint_train_step as jax_train_step,
)
from text_segmentation_image_inpainting_tpu.train.state import create_train_state as jax_state
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import inpaint_unet_state_dict
from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import InpaintLossConfig
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
from text_segmentation_image_inpainting_tpu_torch.train import config as tconfig
from text_segmentation_image_inpainting_tpu_torch.train.inpaint import make_inpaint_train_step
from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

RTOL, ATOL = 1e-3, 1e-4
HW, LR, DEPTH = (32, 32), 0.01, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture
def f32_calls(monkeypatch):
    """Counts ``partial_conv2d_fused``'s f32 forwards and backwards, and
    checks that no f32 kernel launch is counted."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = kpc._forward, kpc.partial_conv2d_backward

    def counted_fwd(x, *a, **k):
        calls["fwd"] += x.dtype == torch.float32
        return fwd(x, *a, **k)

    def counted_bwd(g, x, *a, **k):
        calls["bwd"] += x.dtype == torch.float32
        return bwd(g, x, *a, **k)

    monkeypatch.setattr(kpc, "_forward", counted_fwd)
    monkeypatch.setattr(kpc, "partial_conv2d_backward", counted_bwd)
    before = (kpc.K1F_LAUNCHES, kpc.K2F_LAUNCHES, kpc.K3F_LAUNCHES)
    yield calls
    assert (kpc.K1F_LAUNCHES, kpc.K2F_LAUNCHES, kpc.K3F_LAUNCHES) == before


def _holes(rng, shape):
    m = (rng.random(shape) < 0.6).astype(np.float32)
    m[0, :4, :4] = 0  # windows that see no valid pixel
    return m


@pytest.mark.parametrize("pad", [(1, 1), (0, 1)], ids=["p11", "p01"])
@pytest.mark.parametrize("groups,cout", [((8, 8), 16), ((16, 3), 3)], ids=["decoder", "head"])
def test_f32_partial_conv_and_its_vjp_match_the_xla_twin(groups, cout, pad, f32_calls):
    rng = np.random.default_rng(sum(groups) + cout + pad[0])
    cin = sum(groups)
    x = rng.standard_normal((2, 12, 10, cin)).astype(np.float32)
    m = _holes(rng, (2, 12, 10, len(groups)))
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal((cout,))).astype(np.float32)

    def jax_fn(x, w, b):
        return jpc._partial_conv2d_xla(x, jnp.asarray(m), w, b, groups, (1, 1), pad, (1, 1))

    (want_y, want_m), vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    g = rng.standard_normal(want_y.shape).astype(np.float32)
    want_dx, want_dw, want_db = vjp((jnp.asarray(g), jnp.zeros_like(want_m)))

    leaves = [torch.from_numpy(x).requires_grad_(True),
              torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True),
              torch.from_numpy(b).requires_grad_(True)]
    y, nm = kpc.partial_conv2d_fused(leaves[0], torch.from_numpy(m), leaves[1], leaves[2],
                                     group_sizes=groups, padding=pad)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(nm.detach().numpy(), np.asarray(want_m))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    dx, dw, db = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw).transpose(3, 2, 0, 1),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), rtol=RTOL, atol=ATOL)
    assert f32_calls == {"fwd": 1, "bwd": 1}


@pytest.fixture(scope="module")
def unet_setup():
    unet_vars = jax_unet_variables(JaxInpaintUNet(depth=DEPTH, fuse_up=False), seed=71)
    _, vgg_vars = _jax_vgg(hw=HW, seed=72)
    rng = np.random.default_rng(73)
    batch = {"image": rng.uniform(0, 1, (2, *HW, 3)).astype(np.float32),
             "mask": (rng.random((2, *HW, 1)) > 0.3).astype(np.float32)}
    batch["mask"][1, 4:24, 8:20] = 0
    return unet_vars, vgg_vars, batch


def test_f32_unet_forward_matches_jax(unet_setup, f32_calls):
    """Every stride-1 partial conv of the f32 U-Net (its DEPTH decoder levels,
    the head among them) goes through the f32 path; the output is JAX's f32
    U-Net's (``impl='xla'``)."""
    unet_vars, _, batch = unet_setup
    x, m = batch["image"] * batch["mask"], batch["mask"]
    want = JaxInpaintUNet(depth=DEPTH, fuse_up=False).apply(unet_vars, jnp.asarray(x),
                                                          jnp.asarray(m))
    model = port_unet(unet_vars, depth=DEPTH, dtype=torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(m))
    assert got.dtype == torch.float32 and f32_calls["fwd"] == DEPTH
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_f32_inpaint_step_matches_jax(unet_setup, f32_calls):
    """One f32 SGD step (``run_inpaint --no-bf16``'s arithmetic): terms to
    rtol 1e-4, parameters and BN statistics to rtol 1e-3 / atol 1e-5; the
    backward of every stride-1 layer on the f32 path."""
    unet_vars, vgg_vars, batch = unet_setup
    jmodel = JaxInpaintUNet(depth=DEPTH, fuse_up=False)
    jcfg = jconfig.InpaintTrainConfig(
        image_size=HW, batch_size=2, depth=DEPTH, loss=JaxLossConfig(vgg_dtype="float32"),
        optimizer=jconfig.OptimizerConfig(kind="sgd", learning_rate=LR))
    state = jax_state(unet_vars, jmodel.apply, jcfg.optimizer)
    state, terms = jax.jit(jax_train_step(jmodel, jcfg, vgg_vars))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    want = inpaint_unet_state_dict({"params": jax.device_get(state.params),
                                    "batch_stats": jax.device_get(state.batch_stats)})

    model = port_unet(unet_vars, depth=DEPTH, dtype=torch.float32)
    cfg = tconfig.InpaintTrainConfig(
        image_size=HW, batch_size=2, depth=DEPTH,
        loss=InpaintLossConfig(vgg_dtype="float32", fused_stem=True),
        optimizer=tconfig.OptimizerConfig(kind="sgd", learning_rate=LR))
    tstate = create_train_state(model, cfg.optimizer)
    tstate, got_terms = make_inpaint_train_step(model, cfg, _port_vgg(vgg_vars))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert f32_calls == {"fwd": DEPTH, "bwd": DEPTH}
    for k, v in terms.items():
        np.testing.assert_allclose(got_terms[k].item(), float(v), rtol=1e-4, err_msg=k)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-3, atol=1e-5, err_msg=k)
