"""The training mixes' runner: the port's eager train step, one dispatch per
step, over a pool of batches resident on the device.

Set-up draws ``pool_batches`` distinct batches from the frozen engines
(task 'inpaint': clean pages with irregular holes; 'seg': pages with
their exact text masks), makes the weights from the seed, builds the
model, its Adam state and the step returned by the port's
``make_inpaint_train_step`` or ``make_seg_train_step``, and drives that
step through its first ``checked_steps`` steps on the first batches,
recording what ``correct`` compares: each step's loss, each leaf's first
gradient (from Adam's first moment), each BatchNorm statistic's change in
the first step and each leaf's change over those steps. The same step object then runs the window, cycling the pool.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import judge, pages, program, weights
from portbench.reference import steps
from portbench.reference.precision import PRECISIONS, f32, no_tf32
from portbench.trace import Spans


class Runner:
    def __init__(self, cell, seed: int, device, fault: str | None = None):
        self.cell, self.cfg, self.tr = cell, cell.config, cell.traffic
        self.seed, self.device, self.fault = seed, device, fault
        self.task = self.tr["task"]
        self.spans = Spans()
        self.log = lambda *a: None
        self._t0 = time.perf_counter()

    def _mark(self, what: str) -> None:
        self.log(f"set-up: {what} at {time.perf_counter() - self._t0:.3f} s")

    # -- set-up ------------------------------------------------------------
    def _host_batches(self) -> list:
        tr, (h, w) = self.tr, self.cfg["image_size"]
        b, n = tr["batch"], tr["pool_batches"] * tr["batch"]
        imgs, text = pages.synth_pages_u8(pages.engine_seeds(self.seed, f"{self.task}.pages", n),
                                          (h, w), mode=tr["page_mode"])
        if self.task == "inpaint":
            mask = pages.hole_masks(pages.engine_seeds(self.seed, "inpaint.holes", n), (h, w))
        else:
            mask = text.astype(np.float32)
        return [{"image": imgs[i * b:(i + 1) * b], "mask": mask[i * b:(i + 1) * b]}
                for i in range(tr["pool_batches"])]

    def _to_device(self, hb: dict) -> dict:
        return {"image": torch.from_numpy(hb["image"]).to(self.device).float() / 255.0,
                "mask": torch.from_numpy(np.ascontiguousarray(hb["mask"])).to(self.device)}

    def _weights(self) -> dict:
        part = "unet" if self.task == "inpaint" else "segmenter"
        with torch.device("meta"):
            shapes = dict(steps.build(self.cfg, part, f32()).state_dict())
            if self.task == "inpaint":
                vgg = steps.build(self.cfg, "vgg", f32()).state_dict()
                shapes.update({f"vgg.{k}": v for k, v in vgg.items()})
        return weights.make_weights(shapes, self.seed, f"weights.{self.task}", self.device)

    def setup(self) -> None:
        from text_segmentation_image_inpainting_tpu_torch.ops import depthwise
        from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

        cfg, tr, dev = self.cfg, self.tr, self.device
        self.host = self._host_batches()
        self.pool = [self._to_device(hb) for hb in self.host]
        self._mark("pool drawn and uploaded")
        wts = self._weights()
        opt_cfg = program.optimizer_config(cfg)
        self._flag = depthwise.USE_CUSTOM_WGRAD
        depthwise.USE_CUSTOM_WGRAD = bool(tr.get("custom_wgrad", False))
        if self.task == "inpaint":
            from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import make_vgg
            from text_segmentation_image_inpainting_tpu_torch.train.config import (
                InpaintTrainConfig,
            )
            from text_segmentation_image_inpainting_tpu_torch.train.inpaint import (
                make_inpaint_train_step,
            )

            loss_cfg = program.loss_config(cfg, tr)
            self.model = program.unet(cfg)
            program.load(self.model, {k: v for k, v in wts.items() if not k.startswith("vgg.")})
            self.vgg = make_vgg(loss_cfg)
            program.load(self.vgg, {k[4:]: v for k, v in wts.items() if k.startswith("vgg.")})
            self.vgg = self.vgg.to(dev)
            self.model = self.model.to(dev)
            step = make_inpaint_train_step(
                self.model, InpaintTrainConfig(loss=loss_cfg, optimizer=opt_cfg), self.vgg)
        else:
            from text_segmentation_image_inpainting_tpu_torch.train.config import SegTrainConfig
            from text_segmentation_image_inpainting_tpu_torch.train.seg import make_seg_train_step

            s, sl = cfg["segmenter"], cfg["seg_loss"]
            self.model = program.segmenter(cfg)
            program.load(self.model, wts)
            self.model = self.model.to(dev)
            step = make_seg_train_step(self.model, SegTrainConfig(
                backbone=s["backbone"], head=s["head"], output_stride=s["output_stride"],
                decoder_mid=s["decoder_mid"], bce_weight=sl["bce"], dice_weight=sl["dice"],
                pos_weight=sl["pos_weight"], optimizer=opt_cfg))
        del wts
        self.state = create_train_state(self.model, opt_cfg)
        self.step = self._plant(step, self.fault)
        self._mark("model, state and step built")
        self.readings = self._checked_steps()
        self._mark("checked steps run")
        self.next = tr["checked_steps"]

    def _plant(self, step, fault: str | None):
        """A fault in the trained path, for the harness's own tests."""
        if fault is None:
            return step
        if fault == "frozen_state":  # a step that leaves its state unchanged
            self.state.optimizer.step = lambda *a, **k: None
            return step
        if fault == "half_batch":  # half of the batch left out
            return lambda state, batch: step(
                state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        if fault == "alter":  # the answer changed where it is produced
            self.model.register_forward_hook(lambda m, args, out: out + 1.0)
            return step
        raise ValueError(f"no fault {fault!r}")

    def _checked_steps(self) -> dict:
        beta1 = self.cfg["optimizer"]["beta1"]
        start = {k: v.detach().clone() for k, v in self.model.state_dict().items()
                 if not k.endswith("num_batches_tracked")}
        out = {"loss": []}
        for i in range(self.tr["checked_steps"]):
            self.state, terms = self.step(self.state, self.pool[i])
            out["loss"].append(float(terms["total"]))
            if i == 0:
                st = self.state.optimizer.state
                out["grad"] = {n: (float(st[p]["exp_avg"].double().norm()) / (1.0 - beta1)
                                   if p in st and "exp_avg" in st[p] else 0.0)
                               for n, p in self.model.named_parameters()}
                out["stats1"] = steps.stats_change(self.model.state_dict(), start)
        now = self.model.state_dict()
        out["change"] = {k: float((now[k] - v).double().norm()) for k, v in start.items()}
        return out

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> dict:
        b, pool = self.tr["batch"], self.pool
        dispatch, done, terms = [], 0, None
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while time.perf_counter() < t_end:
            t = time.perf_counter()
            self.state, terms = self.step(self.state, pool[self.next % len(pool)])
            dispatch.append(time.perf_counter() - t)
            self.next += 1
            done += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t_start
        finite = terms is not None and bool(torch.isfinite(terms["total"]))
        for d in dispatch:
            self.spans.add("step_dispatch", d)
        self.log(f"train: {done} steps of {b} pages in {elapsed:.4f} s (window {seconds} s); "
                 f"host dispatch per step median {self.spans.median('step_dispatch') * 1e3:.3f} "
                 f"ms" if dispatch else "train: no step in the window")
        return {"train_pages_per_s": done * b / elapsed, "attempted": done,
                "failed": 0 if finite else 1, "interval_s": elapsed / max(done, 1)}

    def trace_phases(self) -> None:
        pass

    def profile_body(self):
        n = self.tr["profile_steps"]

        def body():
            from torch.profiler import record_function

            for _ in range(n):
                with record_function("portbench.train_step"):
                    self.state, _ = self.step(self.state, self.pool[self.next % len(self.pool)])
                self.next += 1

        return body, n

    def end_profile(self) -> None:
        pass

    # -- after the window --------------------------------------------------------
    def release(self) -> None:
        from text_segmentation_image_inpainting_tpu_torch.ops import depthwise

        del self.state, self.step, self.model, self.pool
        self.vgg = None
        depthwise.USE_CUSTOM_WGRAD = self._flag
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, control: str | None = None, detail: bool = False) -> dict:
        """The numbers compared (``judge.train_numbers``); with ``control``
        the reference in that precision is put in the program's place; with
        ``detail`` also each leaf's norms on both sides (``detail``)."""
        n = self.tr["checked_steps"]
        batches = [self._to_device(hb) for hb in self.host[:n]]
        with no_tf32():
            ref = steps.train_steps(self.cfg, self.task, self._weights(), batches, f32(),
                                    self.device)
            prog = self.readings if control is None else steps.train_steps(
                self.cfg, self.task, self._weights(), batches, PRECISIONS[control](),
                self.device)
        out = judge.train_numbers(prog, ref)
        if detail:
            out["detail"] = {"prog": prog, "ref": ref}
        return out
