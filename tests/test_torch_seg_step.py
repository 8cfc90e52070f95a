"""One whole segmentation train step of the port against the JAX
package's, on the CPU.

The full-width ``TextSegmenter`` (width 1.0, output stride 8) at 32x32,
batch 2: the same weights and BatchNorm statistics (bridged), the same
numpy batch. The port runs with ``USE_CUSTOM_WGRAD`` on, so its 14
stride-1 depthwise convs with C >= 128 take dW from K6's plain version
(at 4x4 with d = 4, every off-centre tap of the deepest ones lies in the
padding); JAX runs its stock path (flag off). SGD, as ``train/config.py``
says: Adam would amplify ulp-level gradient differences. float32: loss
terms to rtol 1e-4, parameters and BN statistics after the step to rtol
1e-3 / atol 1e-5 (the inpainting step test's bounds). ``grad_norm`` is
held to 1e-3, the gradients' own bound: JAX's jitted step and the same
step run eagerly differ by 1.4e-4 in it at this size (XLA reorders the
sums), and the port matches the eager one to 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import text_segmentation_image_inpainting_tpu_torch.ops.depthwise as tdw
from tests.test_torch_bridge import jax_segmenter_variables, one_torch_thread, port_segmenter
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu.train import config as jconfig
from text_segmentation_image_inpainting_tpu.train.seg import make_seg_train_step as jax_train_step
from text_segmentation_image_inpainting_tpu.train.state import create_train_state as jax_state
from text_segmentation_image_inpainting_tpu.train.state import freeze_mask_for as jax_freeze
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import text_segmenter_state_dict
from text_segmentation_image_inpainting_tpu_torch.train import config as tconfig
from text_segmentation_image_inpainting_tpu_torch.train.seg import (
    make_seg_eval_step,
    make_seg_train_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.state import (
    create_train_state,
    freeze_mask_for,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


HW, LR = (32, 32), 0.01


@pytest.fixture(autouse=True)
def _restore_flag():
    prev = tdw.USE_CUSTOM_WGRAD
    yield
    tdw.USE_CUSTOM_WGRAD = prev


@pytest.fixture(scope="module")
def setup():
    """Variables, batch, and the JAX steps, each run once for the module."""
    variables = jax_segmenter_variables(JaxTextSegmenter(), hw=HW, seed=31)
    rng = np.random.default_rng(32)
    batch = {"image": rng.uniform(0, 1, (2, *HW, 3)).astype(np.float32),
             "mask": (rng.random((2, *HW, 1)) < 0.12).astype(np.float32)}
    cache = {}

    def jax_step(freeze, dtype):
        if (freeze, dtype) not in cache:
            cache[freeze, dtype] = _jax_step(variables, batch, freeze=freeze, dtype=dtype)
        return cache[freeze, dtype]

    return variables, batch, jax_step


def _cfg(mod, freeze):
    return mod.SegTrainConfig(image_size=HW, batch_size=2, freeze_encoder=freeze,
                              optimizer=mod.OptimizerConfig(kind="sgd", learning_rate=LR))


def _jax_step(variables, batch, *, freeze, dtype):
    model = JaxTextSegmenter(dtype=dtype)
    cfg = _cfg(jconfig, freeze)
    frozen = jax_freeze(variables["params"], "encoder") if freeze else None
    state = jax_state(variables, model.apply, cfg.optimizer, frozen_mask=frozen)
    state, metrics = jax.jit(jax_train_step(model, cfg))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    new = text_segmenter_state_dict({"params": jax.device_get(state.params),
                                     "batch_stats": jax.device_get(state.batch_stats)})
    return new, {k: float(v) for k, v in metrics.items()}


def _port_step(variables, batch, *, freeze, dtype):
    tdw.USE_CUSTOM_WGRAD = True
    model = port_segmenter(variables, dtype=dtype)
    cfg = _cfg(tconfig, freeze)
    frozen = freeze_mask_for(model, "encoder") if freeze else frozenset()
    state = create_train_state(model, cfg.optimizer, frozen=frozen)
    state, metrics = make_seg_train_step(model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1
    assert all(p.grad is None for p in model.parameters())
    new = {k: v.numpy() for k, v in model.state_dict().items()}
    return new, {k: v.item() for k, v in metrics.items()}, model


@pytest.mark.parametrize("freeze", [False, True], ids=["train-all", "freeze-encoder"])
def test_sgd_step_matches_jax(setup, freeze):
    variables, batch, jax_step = setup
    want, want_m = jax_step(freeze, jnp.float32)
    got, got_m, _ = _port_step(variables, batch, freeze=freeze, dtype=torch.float32)
    assert sorted(got_m) == sorted(want_m) == ["bce", "dice", "grad_norm", "total"]
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-3 if k == "grad_norm" else 1e-4,
                                   err_msg=k)
    before = text_segmenter_state_dict(variables)
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=k)
        moved = not np.array_equal(got[k], before[k])
        if "running" in k:
            # BN trains in every step, with freeze_encoder too (as JAX's)
            assert moved, f"{k} did not move"
        elif k.startswith("encoder.") and freeze:
            assert not moved, f"{k} moved under freeze_encoder"
        elif np.abs(want[k] - before[k]).max() > 1e-6 * np.abs(before[k]).max():
            # (a few BN biases that the next BN cancels have gradients of
            # rounding noise, near 1e-8: an f32 step of lr times that moves
            # them by an ulp or not at all, in either package)
            assert moved, f"{k} did not move"


def test_bf16_step_no_further_from_f32_than_jax_bf16(setup):
    """The bf16 step's loss and parameter update against the f32 step: the
    port's (K6's plain version, dW rounded once to bf16) within 1.5x of
    JAX's own bf16 distance."""
    variables, batch, jax_step = setup
    f32, f32_m = jax_step(False, jnp.float32)
    jbf, jbf_m = jax_step(False, jnp.bfloat16)
    got, got_m, _ = _port_step(variables, batch, freeze=False, dtype=torch.bfloat16)
    before = text_segmenter_state_dict(variables)
    keys = [k for k in f32 if k.endswith((".weight", ".bias"))]

    def dist(new):
        d = [np.linalg.norm((new[k] - before[k]) - (f32[k] - before[k])) for k in keys]
        ref = [np.linalg.norm(f32[k] - before[k]) for k in keys]
        return np.linalg.norm(d) / np.linalg.norm(ref)

    d_port, d_jax = dist(got), dist(jbf)
    assert np.isfinite(list(got_m.values())).all()
    assert d_port <= 1.5 * d_jax, (d_port, d_jax)
    for k in ("total", "grad_norm"):
        t_port = abs(got_m[k] - f32_m[k]) / f32_m[k]
        t_jax = abs(jbf_m[k] - f32_m[k]) / f32_m[k]
        assert t_port <= 1.5 * t_jax + 1e-3, (k, t_port, t_jax)


def test_grad_norm_counts_frozen_grads_once_per_step(setup):
    """grad_norm covers the frozen encoder's raw gradients (as JAX's), and
    they are cleared after each step: two steps on the same batch under
    freeze_encoder give the second step's own norm, not a sum."""
    variables, batch, _ = setup
    tdw.USE_CUSTOM_WGRAD = True
    model = port_segmenter(variables)
    cfg = _cfg(tconfig, True)
    state = create_train_state(model, cfg.optimizer, frozen=freeze_mask_for(model, "encoder"))
    step = make_seg_train_step(model, cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    norms = []
    for i in range(2):
        if i == 1:
            after_first = {k: v.clone() for k, v in model.state_dict().items()}
        state, m = step(state, tb)
        norms.append(m["grad_norm"].item())
        assert all(p.grad is None for p in model.parameters())
    fresh = port_segmenter(variables)
    fresh.load_state_dict(after_first)
    fs = create_train_state(fresh, cfg.optimizer, frozen=freeze_mask_for(fresh, "encoder"))
    _, m = make_seg_train_step(fresh, cfg)(fs, tb)
    np.testing.assert_allclose(norms[1], m["grad_norm"].item(), rtol=1e-5)


def test_eval_step_thresholds_sigmoid_of_f32_logits(setup):
    variables, batch, _ = setup
    model = port_segmenter(variables)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = make_seg_eval_step(model)(None, tb)
    assert sorted(metrics) == ["iou", "precision", "recall"]
    with torch.no_grad():
        pred = (torch.sigmoid(model.eval()(tb["image"]).float()) > 0.5).float()
    tp = (pred * tb["mask"]).sum()
    np.testing.assert_allclose(metrics["recall"].item(), (tp / (tb["mask"].sum() + 1e-6)).item(),
                               rtol=1e-6)
    assert all(0.0 <= v.item() <= 1.0 for v in metrics.values())


def test_grad_accum_waits_for_its_port(setup):
    """grad_accum is ported (``train/accum.py``, held against JAX in
    ``tests/test_torch_accum_multistep.py``); it refuses what JAX's
    refuses: k < 1 and a batch that k does not divide."""
    variables, batch, _ = setup
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k, match in ((3, "divisible"), (0, ">= 1")):
        model = port_segmenter(variables)
        cfg = dataclasses.replace(_cfg(tconfig, False), grad_accum=k)
        with pytest.raises(ValueError, match=match):
            make_seg_train_step(model, cfg)(create_train_state(model, cfg.optimizer), tb)
