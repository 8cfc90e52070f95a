"""The serving mixes' runner: ``PageStreamServer.serve()`` over the page
cleaner, closed loop.

Set-up draws ``pool_batches`` distinct batches of uint8 pages from the
frozen page engine (``page_mode``), makes the weights from the seed (with
BatchNorm statistics and the segmenter head's bias that the reference
sets on the first batch, ``_make_weights``), loads them into the port's
``TextRemovalPipeline`` and starts one ``serve()`` stream over the pool,
cycled; its first ``warm_batches`` results are set-up. The window then
takes results from the same stream: a batch's latency runs from when the
server took it from the feed to when ``serve()`` yielded its result. It
closes with the first result that comes after its time is up, and the
rate counts every result it took over all of its time, so that it is not
rounded to whole batches.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from portbench import judge, pages, program, weights
from portbench.reference import nets, steps
from portbench.reference.precision import PRECISIONS, f32, no_tf32
from portbench.trace import Spans

class Runner:
    def __init__(self, cell, seed: int, device, fault: str | None = None):
        self.cell, self.cfg, self.tr = cell, cell.config, cell.traffic
        self.seed, self.device, self.fault = seed, device, fault
        self.spans = Spans()
        self.log = lambda *a: None
        self._t0 = time.perf_counter()

    def _mark(self, what: str) -> None:
        self.log(f"set-up: {what} at {time.perf_counter() - self._t0:.3f} s")

    # -- set-up ------------------------------------------------------------
    def _make_weights(self, share: float) -> None:
        """Weights from the seed, then, as a trained model would have them,
        every BatchNorm's running statistics those of the first pool batch
        (the reference in f32, in training mode) and the segmenter head's
        bias moved so that the reference marks as many pixels of that batch
        as its true text holds (undilated); the U-Net's statistics are
        taken over the reference's own mask. Kept on the host for the judge."""
        dev = self.device
        with torch.device("meta"):
            shapes = steps.build(self.cfg, "pipeline", f32()).state_dict()
        ref = steps.build(self.cfg, "pipeline", f32()).to(dev)
        ref.load_state_dict(weights.make_weights(shapes, self.seed, "weights.pipeline", dev))
        x = steps.nchw(torch.from_numpy(self.pool[0]).to(dev)).float() / 255.0
        with torch.no_grad(), no_tf32():
            nets.calibrate_bn(ref.seg, lambda: ref.seg(x))
            logits = ref.seg(x).flatten()
            q = torch.quantile(logits[:: max(1, logits.numel() // (1 << 22))], 1.0 - share)
            ref.seg.decoder.head.bias -= q
            text = steps.Pipeline(ref, self.cfg, f32()).text(torch.from_numpy(self.pool[0]).to(dev))
            valid = 1.0 - steps.nchw(text).float()
            nets.calibrate_bn(ref.unet, lambda: ref.unet(x * valid, valid))
        self.weights_host = {k: v.detach().cpu() for k, v in ref.state_dict().items()}

    def _weights(self) -> dict:
        return {k: v.to(self.device) for k, v in self.weights_host.items()}

    def setup(self) -> None:
        cfg, tr, dev = self.cfg, self.tr, self.device
        b, (h, w) = tr["batch"], cfg["image_size"]
        n = tr["pool_batches"] * b
        imgs, text = pages.synth_pages_u8(pages.engine_seeds(self.seed, "serve.pages", n),
                                          (h, w), mode=tr["page_mode"])
        self.pool = imgs.reshape(tr["pool_batches"], b, h, w, 3)
        self._mark("pages drawn")
        self._make_weights(float(text[:b].mean()))
        self._mark("weights made, BatchNorm statistics and head bias set by the reference")
        from text_segmentation_image_inpainting_tpu_torch.pipeline import PageStreamServer

        self.pipe = program.pipeline(cfg)
        program.load(self.pipe, self._weights())
        self.pipe = self.pipe.to(dev).eval()
        self._plant(self.fault)
        self.server = PageStreamServer(self.pipe, depth=tr["depth"])
        self._mark("pipeline built and loaded")
        self.kept = {}  # pool index -> the last (clean, text) served for it
        self._start_stream()
        for _ in range(tr["warm_batches"]):
            self._take()
        self._mark("warm batches served")

    def _plant(self, fault: str | None) -> None:
        """A fault in the served path, for the harness's own tests."""
        if fault is None:
            return
        run = self.pipe.run

        def half_batch(x):  # the second half of each batch never computed
            k = x.shape[0] // 2
            clean, mask = run(x[:k])
            return torch.cat([clean, x[k:].to(clean.dtype)]), torch.cat(
                [mask, torch.zeros_like(mask[: x.shape[0] - k])])

        def alter(x):  # the answer changed where it is produced: the hole inverted
            clean, mask = run(x)
            return torch.where(mask > 0, 1.0 - clean, clean), mask

        self.pipe.run = {"half_batch": half_batch, "alter": alter}[fault]

    def _feed(self):
        i = 0
        while not self._stop.is_set():
            p = i % len(self.pool)
            self._handed.append((p, time.perf_counter()))
            yield self.pool[p]
            i += 1

    def _start_stream(self) -> None:
        self._stop, self._handed = threading.Event(), collections.deque()
        self._it = self.server.serve(self._feed(), prefetch=self.tr["prefetch"])

    def _take(self):
        clean, text = next(self._it)
        t = time.perf_counter()
        p, handed = self._handed.popleft()
        self.kept[p] = (clean, text)
        return p, t - handed

    def _stop_stream(self) -> None:
        self._stop.set()
        for _ in self._it:  # the batches still in flight
            self._handed.popleft()
        self._it = None

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> dict:
        b = self.tr["batch"]
        lat, served = [], 0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while True:  # the window closes with the first result past its time
            p, latency = self._take()
            t_last = time.perf_counter()
            served += 1
            lat.append(latency)
            if t_last > t_end:
                break
        elapsed = t_last - t_start
        self._stop_stream()
        self.log(f"serve: {served} batches of {b} pages in a window of {elapsed:.6f} s "
                 f"({seconds} s asked); the 95th percentile over {len(lat)} batch latencies, "
                 f"their median {np.median(lat) * 1e3:.3f} ms")
        return {"serve_pages_per_s": served * b / elapsed,
                "serve_batch_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "attempted": served, "failed": 0, "interval_s": elapsed / served}

    # -- the traced run's extra phases -----------------------------------------
    def trace_phases(self) -> None:
        from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import to_compute
        from text_segmentation_image_inpainting_tpu_torch.pipeline.sparse import to_uint8

        tr, dev, pipe, sp = self.tr, self.device, self.pipe, self.spans
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)

        def closed(p):  # upload, run, the blocking uint8 read-back
            x = torch.from_numpy(self.pool[p]).to(dev)
            clean, mask = pipe.run(to_compute(x, pipe.compute_dtype))
            return to_uint8(clean).cpu(), mask.to(torch.uint8).cpu()

        for i in range(tr["closed_loop_batches"]):
            sp.host("closed_loop", lambda: closed(i % len(self.pool)))
        x = to_compute(torch.from_numpy(self.pool[0]).to(dev), pipe.compute_dtype)
        with torch.no_grad():
            for _ in range(tr["span_batches"]):
                sp.host("pipeline_run", lambda: (pipe.run(x), sync()))
            valid = 1.0 - pipe.segment(x).to(x.dtype)
            for _ in range(tr["span_batches"]):
                sp.events("segmenter", lambda: pipe.seg(x), dev)
                sp.events("unet", lambda: pipe.unet(x * valid, valid), dev)

    def profile_body(self):
        """(body, units): ``body`` takes ``profile_batches`` results of a
        running stream; units None (the metrics count the batches)."""
        self._start_stream()
        for _ in range(self.tr["profile_warm"]):
            self._take()

        def body():
            from torch.profiler import record_function

            for _ in range(self.tr["profile_batches"]):
                with record_function("portbench.serve_next"):
                    self._take()

        return body, None

    def end_profile(self) -> None:
        self._stop_stream()

    # -- after the window --------------------------------------------------------
    def release(self) -> None:
        del self.server, self.pipe
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        rng = np.random.default_rng([int(self.seed) & (2**63 - 1), 7])
        served = sorted(self.kept)
        k = min(self.tr["sample_batches"], len(served))
        return [int(p) for p in rng.choice(served, size=k, replace=False)]

    def judge(self, control: str | None = None) -> dict:
        """The numbers compared (``judge.serve_numbers``); with ``control``
        the reference in that precision is put in the program's place."""
        dev = self.device
        ref = steps.build(self.cfg, "pipeline", f32()).to(dev)
        ref.load_state_dict(self._weights())
        ref_pipe = steps.Pipeline(ref, self.cfg, f32())
        ctl = None
        if control is not None:
            c = steps.build(self.cfg, "pipeline", PRECISIONS[control]()).to(dev)
            c.load_state_dict(self._weights())
            ctl = steps.Pipeline(c, self.cfg, c.seg.prec)
        answers = []
        with no_tf32():
            for p in self.sample():
                x = torch.from_numpy(self.pool[p]).to(dev)
                if ctl is None:
                    clean, text = self.kept[p]
                else:
                    clean, text = (t.cpu().numpy() for t in ctl.run(x))
                score, spread = ref_pipe.scores(x)
                ref_clean = ref_pipe.clean(x, torch.from_numpy(np.asarray(text)).to(dev))
                answers.append((np.asarray(clean), np.asarray(text), score.cpu().numpy(),
                                spread, ref_clean.cpu().numpy()))
        return judge.serve_numbers(answers, ref_pipe.logit_threshold)
