"""One whole inpainting train step of the port against the JAX package's,
on the CPU.

Same U-Net weights and BatchNorm statistics, same VGG weights (bridged),
same numpy batch; JAX ``InpaintUNet(impl='xla', fuse_up=False)`` (its
autodiff is the partial-conv kernels' custom-VJP math) with its stock
VGG path, the port with ``fused_stem`` (whose CPU versions are the plain
ones). SGD, as ``train/config.py`` says: Adam would amplify ulp-level
gradient differences. float32: loss terms to rtol 1e-4, parameters and
BN statistics after the step to rtol 1e-3 / atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import jax_unet_variables, port_unet
from tests.test_torch_vgg import _jax_vgg, _port_vgg
from text_segmentation_image_inpainting_tpu.losses.inpainting import (
    InpaintLossConfig as JaxLossConfig,
)
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.train import config as jconfig
from text_segmentation_image_inpainting_tpu.train.inpaint import (
    make_inpaint_train_step as jax_train_step,
)
from text_segmentation_image_inpainting_tpu.train.state import create_train_state as jax_state
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import inpaint_unet_state_dict
from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import InpaintLossConfig
from text_segmentation_image_inpainting_tpu_torch.train import config as tconfig
from text_segmentation_image_inpainting_tpu_torch.train.inpaint import (
    make_inpaint_eval_step,
    make_inpaint_train_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

DEPTH, HW, LR = 3, (32, 32), 0.01


@pytest.fixture(scope="module")
def setup():
    unet_vars = jax_unet_variables(JaxInpaintUNet(depth=DEPTH, fuse_up=False), seed=21)
    vgg_model, vgg_vars = _jax_vgg(hw=HW, seed=22)
    rng = np.random.default_rng(23)
    batch = {"image": rng.uniform(0, 1, (2, *HW, 3)).astype(np.float32),
             "mask": (rng.random((2, *HW, 1)) > 0.3).astype(np.float32)}
    batch["mask"][0, 8:20, 4:24] = 0
    return unet_vars, vgg_vars, batch


def _jax_step(unet_vars, vgg_vars, batch, *, freeze_bn, dtype):
    model = JaxInpaintUNet(depth=DEPTH, fuse_up=False, dtype=dtype)
    cfg = jconfig.InpaintTrainConfig(
        image_size=HW, batch_size=2, depth=DEPTH, freeze_bn=freeze_bn,
        loss=JaxLossConfig(vgg_dtype=jnp.dtype(dtype).name),
        optimizer=jconfig.OptimizerConfig(kind="sgd", learning_rate=LR),
    )
    state = jax_state(unet_vars, model.apply, cfg.optimizer)
    state, terms = jax.jit(jax_train_step(model, cfg, vgg_vars))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    new = inpaint_unet_state_dict({"params": jax.device_get(state.params),
                                   "batch_stats": jax.device_get(state.batch_stats)})
    return new, {k: float(v) for k, v in terms.items()}


def _port_step(unet_vars, vgg_vars, batch, *, freeze_bn, dtype):
    model = port_unet(unet_vars, depth=DEPTH, dtype=dtype)
    vgg = _port_vgg(vgg_vars, dtype=dtype)
    cfg = tconfig.InpaintTrainConfig(
        image_size=HW, batch_size=2, depth=DEPTH, freeze_bn=freeze_bn,
        loss=InpaintLossConfig(vgg_dtype=str(dtype).split(".")[1], fused_stem=True),
        optimizer=tconfig.OptimizerConfig(kind="sgd", learning_rate=LR),
    )
    state = create_train_state(model, cfg.optimizer)
    state, terms = make_inpaint_train_step(model, cfg, vgg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1
    new = {k: v.numpy() for k, v in model.state_dict().items()}
    return new, {k: v.item() for k, v in terms.items()}, model


@pytest.mark.parametrize("freeze_bn", [False, True], ids=["train-bn", "freeze-enc-bn"])
def test_sgd_step_matches_jax(setup, freeze_bn):
    unet_vars, vgg_vars, batch = setup
    want, want_terms = _jax_step(unet_vars, vgg_vars, batch, freeze_bn=freeze_bn,
                                 dtype=jnp.float32)
    got, got_terms, _ = _port_step(unet_vars, vgg_vars, batch, freeze_bn=freeze_bn,
                                   dtype=torch.float32)
    assert sorted(got_terms) == sorted(want_terms)
    for k in want_terms:
        np.testing.assert_allclose(got_terms[k], want_terms[k], rtol=1e-4, err_msg=k)
    before = inpaint_unet_state_dict(unet_vars)
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=k)
        if k.endswith((".weight", ".bias")) and "bns" not in k:
            assert not np.array_equal(got[k], before[k]), f"{k} did not move"
    enc_stats = [k for k in want if k.startswith("enc_bns") and "running" in k]
    dec_stats = [k for k in want if k.startswith("dec_bns") and "running" in k]
    assert enc_stats and dec_stats
    assert all(np.array_equal(got[k], before[k]) == freeze_bn for k in enc_stats)
    assert not any(np.array_equal(got[k], before[k]) for k in dec_stats)


def test_bf16_step_no_further_from_f32_than_jax_bf16(setup):
    """The bf16 step's loss and parameter update against the f32 step:
    the port's within 1.5x of JAX's own bf16 distance (bf16 rounds at other
    places in the two: the port keeps each partial conv's f32 sum through
    the epilogue, JAX's XLA twin rounds it first)."""
    unet_vars, vgg_vars, batch = setup
    f32, f32_terms = _jax_step(unet_vars, vgg_vars, batch, freeze_bn=False, dtype=jnp.float32)
    jbf, jbf_terms = _jax_step(unet_vars, vgg_vars, batch, freeze_bn=False, dtype=jnp.bfloat16)
    got, got_terms, _ = _port_step(unet_vars, vgg_vars, batch, freeze_bn=False,
                                   dtype=torch.bfloat16)
    before = inpaint_unet_state_dict(unet_vars)
    keys = [k for k in f32 if k.endswith((".weight", ".bias"))]

    def dist(new):
        d = [np.linalg.norm((new[k] - before[k]) - (f32[k] - before[k])) for k in keys]
        ref = [np.linalg.norm(f32[k] - before[k]) for k in keys]
        return np.linalg.norm(d) / np.linalg.norm(ref)

    d_port, d_jax = dist(got), dist(jbf)
    t_port = abs(got_terms["total"] - f32_terms["total"]) / f32_terms["total"]
    t_jax = abs(jbf_terms["total"] - f32_terms["total"]) / f32_terms["total"]
    assert np.isfinite(list(got_terms.values())).all()
    assert d_port <= 1.5 * d_jax, (d_port, d_jax)
    assert t_port <= 1.5 * t_jax + 1e-3, (t_port, t_jax)


def test_eval_step_and_remat(setup):
    """The eval step scores the composite; ``remat='full'`` gives the
    step of ``remat='none'`` and moves the BN statistics once."""
    unet_vars, vgg_vars, batch = setup
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = []
    for remat in ("none", "full"):
        model = port_unet(unet_vars, depth=DEPTH)
        cfg = tconfig.InpaintTrainConfig(
            image_size=HW, batch_size=2, depth=DEPTH, remat=remat,
            loss=InpaintLossConfig(fused_stem=True),
            optimizer=tconfig.OptimizerConfig(kind="sgd", learning_rate=LR))
        state = create_train_state(model, cfg.optimizer)
        make_inpaint_train_step(model, cfg, _port_vgg(vgg_vars))(state, tb)
        runs.append(model.state_dict())
    for k in runs[0]:
        np.testing.assert_allclose(runs[1][k].numpy(), runs[0][k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    metrics = make_inpaint_eval_step(port_unet(unet_vars, depth=DEPTH))(None, tb)
    assert sorted(metrics) == ["l1", "psnr", "ssim"]
    assert all(np.isfinite(v.item()) for v in metrics.values())


def test_grad_accum_waits_for_its_port():
    cfg = dataclasses.replace(tconfig.InpaintTrainConfig(), grad_accum=2)
    with pytest.raises(NotImplementedError, match="accum"):
        make_inpaint_train_step(None, cfg, None)
