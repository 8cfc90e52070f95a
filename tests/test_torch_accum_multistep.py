"""Gradient accumulation (``train/accum.py``) and multi-step dispatch
(``train/multistep.py``) of the port against the JAX package's, on the
CPU, and both training CLIs with the flags they unlock.

The same bridged weights and numpy batch through both, SGD. The inpaint
step at the bounds of ``tests/test_torch_train_step.py`` (f32; loss terms
to rtol 1e-4, parameters and BN statistics after the step to rtol 1e-3 /
atol 1e-5). The seg steps run in float64 on both sides and are held to
rtol 1e-9: at this size (width 0.35, 32^2, microbatches of 2) JAX's own
f32 step is 3e-3 off its f64 ``grad_norm`` (BatchNorm's backward
amplifies the sums' rounding), so f32 cannot witness the semantics, and
f64 agrees to 1e-14. The
duplicated-halves case of JAX's ``tests/test_grad_accum_multistep.py``
runs in float64 (there the accumulated step must equal the big-batch step
to rtol 1e-9: the microbatches' BatchNorm statistics equal the big
batch's). On the CPU ``make_multi_step`` is a plain loop of the step; on
CUDA it replays a CUDA graph (``tests/test_torch_kernels.py``, card only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import (
    jax_segmenter_variables,
    jax_unet_variables,
    one_torch_thread,
    port_segmenter,
    port_unet,
)
from tests.test_torch_vgg import _jax_vgg, _port_vgg
from text_segmentation_image_inpainting_tpu.losses.inpainting import (
    InpaintLossConfig as JaxLossConfig,
)
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu.train import config as jconfig
from text_segmentation_image_inpainting_tpu.train import multistep as jmulti
from text_segmentation_image_inpainting_tpu.train.inpaint import (
    make_inpaint_train_step as jax_inpaint_step,
)
from text_segmentation_image_inpainting_tpu.train.seg import make_seg_train_step as jax_seg_step
from text_segmentation_image_inpainting_tpu.train.state import create_train_state as jax_state
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import (
    inpaint_unet_state_dict,
    text_segmenter_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import InpaintLossConfig
from text_segmentation_image_inpainting_tpu_torch.train import config as tconfig
from text_segmentation_image_inpainting_tpu_torch.train.accum import microbatches
from text_segmentation_image_inpainting_tpu_torch.train.inpaint import make_inpaint_train_step
from text_segmentation_image_inpainting_tpu_torch.train.multistep import (
    clamp_steps_per_dispatch,
    make_multi_step,
    stack_host_batches,
)
from text_segmentation_image_inpainting_tpu_torch.train.seg import make_seg_train_step
from text_segmentation_image_inpainting_tpu_torch.train.state import (
    create_train_state,
    learning_rate_at,
    learning_rate_tensor,
)

HW, LR, WIDTH, DEPTH = (32, 32), 0.01, 0.35, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _close_states(got, want, before=None):  # the inpaint step's bounds
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=k)
        if before is not None and "running" in k:
            assert not np.array_equal(got[k], before[k]), k


def _close_terms(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def _seg_batch(rng, n):
    return {"image": rng.uniform(0, 1, (n, *HW, 3)).astype(np.float32),
            "mask": (rng.random((n, *HW, 1)) < 0.15).astype(np.float32)}


@pytest.fixture(scope="module")
def seg_setup():
    variables = jax_segmenter_variables(JaxTextSegmenter(width_mult=WIDTH), hw=HW, seed=41)
    return variables, _seg_batch(np.random.default_rng(42), 4)


def _seg_cfg(mod, **kw):
    return mod.SegTrainConfig(image_size=HW, batch_size=4, width_mult=WIDTH,
                              optimizer=mod.OptimizerConfig(kind="sgd", learning_rate=LR), **kw)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _f64_tree(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _jax_seg_f64(variables, batches, step_fn, **cfg_kw):
    """JAX's seg step (or its multi-step) in float64: new state dict, metrics."""
    with jax.enable_x64():
        model = JaxTextSegmenter(width_mult=WIDTH, dtype=jnp.float64)
        cfg = _seg_cfg(jconfig, **cfg_kw)
        state = jax_state(_f64_tree(variables), model.apply, cfg.optimizer)
        state, metrics = jax.jit(step_fn(jax_seg_step(model, cfg)))(state, _f64_tree(batches))
        new = text_segmenter_state_dict({"params": jax.device_get(state.params),
                                         "batch_stats": jax.device_get(state.batch_stats)})
        return new, {k: np.asarray(v) for k, v in metrics.items()}


def _port_seg_f64(variables):
    return port_segmenter(variables, width_mult=WIDTH, dtype=torch.float64).double()


def _f64_tensors(batch):
    return {k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in batch.items()}


def _exact(got, want):
    """rtol 1e-9, but grad_norm: both packages take it in f32."""
    for k in (k for k in want if not k.endswith("num_batches_tracked")):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-6 if k == "grad_norm" else 1e-9, atol=1e-11,
                                   err_msg=k)


def test_seg_step_with_grad_accum_matches_jax(seg_setup):
    variables, batch = seg_setup
    want, want_m = _jax_seg_f64(variables, batch, lambda f: f, grad_accum=2)
    pm = _port_seg_f64(variables)
    ps = create_train_state(pm, _seg_cfg(tconfig).optimizer)
    ps, got_m = make_seg_train_step(pm, _seg_cfg(tconfig, grad_accum=2))(ps, _f64_tensors(batch))
    assert ps.step == 1 and all(p.grad is None for p in pm.parameters())
    assert sorted(got_m) == sorted(want_m) == ["bce", "dice", "grad_norm", "total"]
    _exact({k: v.item() for k, v in got_m.items()}, want_m)
    got = {k: v.numpy() for k, v in pm.state_dict().items() if not k.endswith("tracked")}
    _exact(got, want)
    before = text_segmenter_state_dict(variables)
    assert all(not np.array_equal(got[k], before[k]) for k in got if "running" in k)


@pytest.fixture(scope="module")
def inpaint_setup():
    unet_vars = jax_unet_variables(JaxInpaintUNet(depth=DEPTH, fuse_up=False), seed=43)
    _, vgg_vars = _jax_vgg(hw=HW, seed=44)
    rng = np.random.default_rng(45)
    batch = {"image": rng.uniform(0, 1, (4, *HW, 3)).astype(np.float32),
             "mask": (rng.random((4, *HW, 1)) > 0.3).astype(np.float32)}
    return unet_vars, vgg_vars, batch


def test_inpaint_step_with_grad_accum_matches_jax(inpaint_setup):
    unet_vars, vgg_vars, batch = inpaint_setup
    model = JaxInpaintUNet(depth=DEPTH, fuse_up=False)
    cfg = jconfig.InpaintTrainConfig(image_size=HW, batch_size=4, depth=DEPTH, grad_accum=2,
                                     loss=JaxLossConfig(vgg_dtype="float32"),
                                     optimizer=jconfig.OptimizerConfig(kind="sgd",
                                                                       learning_rate=LR))
    state = jax_state(unet_vars, model.apply, cfg.optimizer)
    state, terms = jax.jit(jax_inpaint_step(model, cfg, vgg_vars))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    want = inpaint_unet_state_dict({"params": jax.device_get(state.params),
                                    "batch_stats": jax.device_get(state.batch_stats)})
    pm = port_unet(unet_vars, depth=DEPTH)
    tcfg = tconfig.InpaintTrainConfig(image_size=HW, batch_size=4, depth=DEPTH, grad_accum=2,
                                      loss=InpaintLossConfig(fused_stem=True),
                                      optimizer=tconfig.OptimizerConfig(kind="sgd",
                                                                        learning_rate=LR))
    ps = create_train_state(pm, tcfg.optimizer)
    ps, got = make_inpaint_train_step(pm, tcfg, _port_vgg(vgg_vars))(ps, _tensors(batch))
    _close_terms({k: v.item() for k, v in got.items()}, {k: float(v) for k, v in terms.items()})
    _close_states({k: v.numpy() for k, v in pm.state_dict().items()}, want,
                  inpaint_unet_state_dict(unet_vars))


def _dup(batch):
    # [a, a, b, b]: the strided split's microbatch j is [a, b] itself
    return {k: np.repeat(v, 2, axis=0) for k, v in batch.items()}


def _f64(model):
    return model.double()


@pytest.mark.parametrize("kind", ["seg", "inpaint"])
def test_accumulated_step_equals_the_big_batch_on_duplicated_halves(kind, seg_setup,
                                                                    inpaint_setup):
    """float64, SGD: k = 2 on [a, a, b, b] equals k = 1 on it to 1e-9,
    parameters and the mean loss."""
    f64 = torch.float64
    runs = []
    for k in (1, 2):
        if kind == "seg":
            variables, batch = seg_setup
            model = _f64(port_segmenter(variables, width_mult=WIDTH, dtype=f64))
            cfg = _seg_cfg(tconfig, grad_accum=k)
            step = make_seg_train_step(model, cfg)
        else:
            unet_vars, vgg_vars, batch = inpaint_setup
            model = _f64(port_unet(unet_vars, depth=DEPTH, dtype=f64))
            cfg = tconfig.InpaintTrainConfig(
                image_size=HW, batch_size=4, depth=DEPTH, grad_accum=k,
                loss=InpaintLossConfig(vgg_dtype="float64", fused_stem=True),
                optimizer=tconfig.OptimizerConfig(kind="sgd", learning_rate=LR))
            step = make_inpaint_train_step(model, cfg, _f64(_port_vgg(vgg_vars, dtype=f64)))
        half = {n: v[:2].astype(np.float64) for n, v in batch.items()}
        state = create_train_state(model, cfg.optimizer)
        _, terms = step(state, {n: torch.from_numpy(v) for n, v in _dup(half).items()})
        runs.append(({n: t.clone() for n, t in model.state_dict().items()}, terms["total"]))
    (p1, t1), (p2, t2) = runs
    np.testing.assert_allclose(t2.item(), t1.item(), rtol=1e-9)
    for n in p1:
        if p1[n].is_floating_point() and "running" not in n:
            np.testing.assert_allclose(p2[n].numpy(), p1[n].numpy(), rtol=1e-9, atol=1e-11,
                                       err_msg=n)


def test_microbatches_split_strided_and_check_k():
    batch = {"x": torch.arange(6)}
    assert [mb["x"].tolist() for mb in microbatches(batch, 3)] == [[0, 3], [1, 4], [2, 5]]
    with pytest.raises(ValueError, match="divisible"):
        microbatches(batch, 4)
    with pytest.raises(ValueError, match=">= 1"):
        microbatches(batch, 0)


def test_multi_step_on_the_cpu_matches_jax_and_the_loop(seg_setup):
    """float64, as the seg step above: three steps stacked (3, ...)."""
    variables, _ = seg_setup
    rng = np.random.default_rng(46)
    batches = [_seg_batch(rng, 2) for _ in range(3)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    want, jm = _jax_seg_f64(variables, stacked, jmulti.make_multi_step)

    runs = []
    for how in ("multi", "loop"):
        pm = _port_seg_f64(variables)
        state = create_train_state(pm, _seg_cfg(tconfig).optimizer)
        step = make_seg_train_step(pm, _seg_cfg(tconfig))
        if how == "multi":
            state, m = make_multi_step(step)(state, _f64_tensors(stacked))
        else:
            per = []
            for b in batches:
                state, mm = step(state, _f64_tensors(b))
                per.append(mm)
            m = {k: torch.stack([x[k] for x in per]) for k in per[0]}
        assert state.step == 3
        runs.append(({k: v.clone() for k, v in pm.state_dict().items()}, m))
    (sd, m), (sd_loop, m_loop) = runs
    for k in sd:
        assert torch.equal(sd[k], sd_loop[k]), k
    assert all(torch.equal(m[k], m_loop[k]) for k in m)
    _exact({k: v.numpy() for k, v in sd.items() if not k.endswith("tracked")}, want)
    assert {k: tuple(v.shape) for k, v in m.items()} == {k: (3,) for k in jm}
    _exact({k: v.numpy() for k, v in m.items()}, jm)


def test_stack_host_batches_groups_and_drops_tail_as_jax():
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    out = list(stack_host_batches(iter(batches), 2))
    want = list(jmulti.stack_host_batches(iter(batches), 2))
    assert len(out) == len(want) == 2
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a["x"], b["x"])
    assert out[0]["x"].shape == (2, 2, 3)
    with pytest.raises(ValueError, match=">= 1"):
        next(stack_host_batches(iter(batches), 0))


@pytest.mark.parametrize("k,bounds,want", [
    (8, (50, 500), 5), (10, (50, 500), 10), (3, (50, 500), 2), (7, (50, 500), 5),
    (1, (50, 500), 1), (4, (7, 500), 1), (0, (50, 500), 1), (6, (0, 12), 6)])
def test_clamp_steps_per_dispatch_as_jax(k, bounds, want):
    assert clamp_steps_per_dispatch(k, *bounds) == jmulti.clamp_steps_per_dispatch(k, *bounds) \
        == want


def test_device_schedule_follows_the_host_schedule():
    for kw in (dict(warmup_steps=4), dict(warmup_steps=2, restart_period=5, restart_cycles=3),
               dict(restart_period=4, restart_cycles=2), {}):
        cfg = tconfig.OptimizerConfig(learning_rate=0.3, **kw)
        for count in range(20):
            got = learning_rate_tensor(cfg, torch.tensor(float(count), dtype=torch.float64))
            np.testing.assert_allclose(got.item(), learning_rate_at(cfg, count), rtol=1e-12,
                                       atol=1e-15, err_msg=f"{kw} {count}")


def test_capturable_state_needs_adam():
    model = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="adam"):
        create_train_state(model, tconfig.OptimizerConfig(kind="sgd"), capturable=True)


JAX_SEG_KEYS = {"step", "time", "bce", "dice", "total", "grad_norm", "val_iou", "val_precision",
                "val_recall", "pages_per_sec"}
JAX_INPAINT_KEYS = {"step", "time", "valid", "hole", "perceptual", "style_out", "style_comp", "tv",
                    "total", "val_psnr", "val_ssim", "val_l1", "pages_per_sec"}


def _records(path):
    import json

    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("cli", ["seg", "inpaint"])
def test_clis_accept_the_new_flags(cli, tmp_path, monkeypatch, capsys):
    """--grad-accum 2 --steps-per-dispatch 2 with the experiment tracks
    (seg: --backbone xception --head deeplab; inpaint: --attention-sn):
    5 steps truncated to 4, two dispatches logged as JAX logs them."""
    from text_segmentation_image_inpainting_tpu_torch.train import run_inpaint, run_seg

    monkeypatch.chdir(tmp_path)
    common = ["--steps", "5", "--batch-size", "4", "--image-size", "32", "--log-every", "2",
              "--ckpt-every", "4", "--val-batches", "1", "--device", "cpu", "--grad-accum", "2",
              "--steps-per-dispatch", "2", "--ckpt-dir", str(tmp_path / "ckpt")]
    if cli == "seg":
        state = run_seg.main([*common, "--width-mult", "0.25", "--backbone", "xception",
                              "--head", "deeplab"])
        keys = JAX_SEG_KEYS
        assert len(state.model.encoder.mid) == 8 and hasattr(state.model.decoder, "image_pool")
    else:
        state = run_inpaint.main([*common, "--depth", "3", "--attention-sn", "--fused-stem"])
        keys = JAX_INPAINT_KEYS
        assert state.model.attn is not None and state.model.attn.spectral_norm
    out = capsys.readouterr().out
    assert "--steps truncated 5 -> 4" in out
    assert state.step == 4 and (tmp_path / "ckpt" / "step_4.pt").exists()
    rows = _records(tmp_path / "logs" / f"{cli}.jsonl")
    assert [r["step"] for r in rows] == [2, 4]
    assert set(rows[1]) == keys and set(rows[0]) == keys - {"pages_per_sec"}
    assert all(np.isfinite(v) for r in rows for v in r.values())
    run = run_seg if cli == "seg" else run_inpaint
    run.main([*common[:-1], str(tmp_path / "c2"), "--steps-per-dispatch", "3", "--steps", "2",
              *(["--width-mult", "0.25"] if cli == "seg" else ["--depth", "3"])])
    assert "steps-per-dispatch clamped 3 -> 2" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="must divide --batch-size"):
        run.main([*common, "--grad-accum", "3"])
