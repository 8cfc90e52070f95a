"""The plain reference holds the port's four entry points at a small size
on the CPU, on the same seeded weights and inputs: what ties the
reference to the program. The reference itself imports nothing of the
port (test_portbench_guard.py); these tests may."""


import numpy as np
import pytest
import torch

from portbench import harness, judge, pages, program, weights
from portbench.reference import steps
from portbench.reference.precision import f32

from .conftest import tiny


def _cell(name, dtype="float32"):
    return tiny(harness.load_cell(name), dtype)


def test_served_pages_are_the_references():
    from text_segmentation_image_inpainting_tpu_torch.pipeline import PageStreamServer

    cfg = _cell("mnv2_pconv8.serve").config
    with torch.device("meta"):
        shapes = steps.build(cfg, "pipeline", f32()).state_dict()
    w = weights.make_weights(shapes, 11, "test", "cpu")
    pipe = program.pipeline(cfg)
    program.load(pipe, w)
    ref = steps.build(cfg, "pipeline", f32())
    ref.load_state_dict(w)
    ref_pipe = steps.Pipeline(ref, cfg, f32())
    imgs, _ = pages.synth_pages_u8(pages.engine_seeds(11, "test", 6), (64, 64))
    batches = imgs.reshape(3, 2, 64, 64, 3)
    served = list(PageStreamServer(pipe.eval(), depth=2).serve(iter(batches)))
    assert len(served) == 3
    for (clean, text), x in zip(served, batches):
        r_clean, r_text = (t.numpy() for t in ref_pipe.run(torch.from_numpy(x)))
        assert 0 < text.mean() < 1
        assert np.array_equal(text, r_text)
        assert np.abs(clean.astype(int) - r_clean.astype(int)).max() <= 1


def _port_steps(cfg, task, w, batches):
    """The port's own step, in float64, as the runner drives it."""
    from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

    opt = program.optimizer_config(cfg)
    if task == "inpaint":
        from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import make_vgg
        from text_segmentation_image_inpainting_tpu_torch.train.config import InpaintTrainConfig
        from text_segmentation_image_inpainting_tpu_torch.train.inpaint import (
            make_inpaint_train_step,
        )

        loss_cfg = program.loss_config(cfg, {"vgg_dtype": "float64", "fused_stem": True})
        model, vgg = program.unet(cfg), make_vgg(loss_cfg)
        program.load(model, {k: v for k, v in w.items() if not k.startswith("vgg.")})
        program.load(vgg, {k[4:]: v for k, v in w.items() if k.startswith("vgg.")})
        vgg.double()
        step = make_inpaint_train_step(model.double(), InpaintTrainConfig(
            loss=loss_cfg, optimizer=opt), vgg)
    else:
        from text_segmentation_image_inpainting_tpu_torch.train.config import SegTrainConfig
        from text_segmentation_image_inpainting_tpu_torch.train.seg import make_seg_train_step

        s, sl = cfg["segmenter"], cfg["seg_loss"]
        model = program.segmenter(cfg)
        program.load(model, w)
        step = make_seg_train_step(model.double(), SegTrainConfig(
            backbone=s["backbone"], head=s["head"], pos_weight=sl["pos_weight"], optimizer=opt))
    state = create_train_state(model, opt)
    start = {k: v.clone() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    out = {"loss": []}
    for i, b in enumerate(batches):
        state, terms = step(state, b)
        out["loss"].append(float(terms["total"]))
        if i == 0:
            st = state.optimizer.state
            out["grad"] = {n: float(st[p]["exp_avg"].norm()) / (1 - cfg["optimizer"]["beta1"])
                           for n, p in model.named_parameters()}
            out["stats1"] = steps.stats_change(model.state_dict(), start)
    now = model.state_dict()
    out["change"] = {k: float((now[k] - v).norm()) for k, v in start.items()}
    return out


@pytest.mark.parametrize("name", ["mnv2_pconv8.train_inpaint", "mnv2_pconv8.train_seg",
                                  "xception_pconv8.train_seg"])
def test_train_steps_are_the_references(name):
    from text_segmentation_image_inpainting_tpu_torch.ops import depthwise

    cell = _cell(name, "float64")
    drv = harness.mix_module(cell).Runner(cell, 12, torch.device("cpu"))
    host = drv._host_batches()[:2]
    batches = [{k: v.double() for k, v in drv._to_device(hb).items()} for hb in host]
    w = drv._weights()
    flag = depthwise.USE_CUSTOM_WGRAD
    depthwise.USE_CUSTOM_WGRAD = bool(cell.traffic.get("custom_wgrad"))
    try:
        prog = _port_steps(cell.config, cell.traffic["task"], w, batches)
    finally:
        depthwise.USE_CUSTOM_WGRAD = flag
    ref = steps.train_steps(cell.config, cell.traffic["task"], w, batches, f32(), "cpu",
                            torch.float64)
    numbers = judge.train_numbers(prog, ref)
    # the port takes the partial convs' window ratio in f32 (as JAX does) and
    # BatchNorm's variance in one pass, so its float64 steps agree to about
    # 1e-7 a step, which two Adam steps carry to about 2e-5 at the worst
    # leaf: a hundredth of what its bfloat16 steps read on the card
    assert all(numbers[k] < 1e-4 for k in ("loss_gap", "grad_gap", "change_gap")), numbers
    assert ref["loss"][1] != ref["loss"][0]  # the steps did something
