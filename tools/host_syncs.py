#!/usr/bin/env python3
"""Host synchronizations inside one ``TextRemovalPipeline.run``, on one NVIDIA GPU.

Builds the default pipeline (``TextSegmenter`` width 1.0, output stride
8, ``InpaintUNet(depth=8)``, bf16, random weights from seed 0), warms it
up on a batch of 8 pages of 512^2 on the card, then records one ``run``
with torch.profiler, with no synchronize inside the window, and counts
the host rows that block and start inside the call (the profiler's own
stop adds a ``cudaDeviceSynchronize`` after it): ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize`` and the blocking
``cudaMemcpy`` forms. A blocking ``torch.tensor(..., device=cuda)``
recorded the same way shows that the count can see one; an empty window
shows none. The script touches nothing but the port package, so it also
runs in an older tree (copy it there) to count that tree's ``run``. Last
it times ``run`` as ``chip_smoke.py`` does (CUDA events around each call,
median of 20), for an A/B of two trees in one call. With
``--inpaint-step`` it counts one inpaint train step instead (depth 8,
512^2, batch 8, bf16, fused stem, Adam; random weights), after two
warm-up steps, and times the step the same way.

    python3 tools/host_syncs.py [--inpaint-step]
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

RUNS = 20
WINDOW = "host_syncs.window"
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpyToSymbol", "cudaMemcpyFromSymbol",
            "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


def blocking_calls(fn) -> Counter:
    """The blocking CUDA API rows the host issues while ``fn`` runs, by
    name. Only rows that start inside a ``record_function`` range around
    ``fn`` count: stopping the profiler issues a ``cudaDeviceSynchronize``
    of its own, after that range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
    torch.cuda.synchronize()
    events = prof.events()
    window = next(e for e in events
                  if e.name == WINDOW and e.device_type == torch.autograd.DeviceType.CPU)
    start, end = window.time_range.start, window.time_range.end
    return Counter(e.name for e in events
                   if e.name in BLOCKING and start <= e.time_range.start <= end)


def inpaint_step(dev, pages):
    """One inpaint train step's callable (depth 8, bf16, fused stem, Adam)."""
    from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
        InpaintLossConfig,
        make_vgg,
    )
    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet
    from text_segmentation_image_inpainting_tpu_torch.train.config import InpaintTrainConfig
    from text_segmentation_image_inpainting_tpu_torch.train.inpaint import make_inpaint_train_step
    from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

    loss = InpaintLossConfig(vgg_dtype="bfloat16", fused_stem=True)
    torch.manual_seed(0)
    vgg = make_vgg(loss).to(dev)
    model = InpaintUNet(depth=8, dtype=torch.bfloat16).to(dev)
    cfg = InpaintTrainConfig(loss=loss)
    state = create_train_state(model, cfg.optimizer)
    step = make_inpaint_train_step(model, cfg, vgg)
    holes = (torch.rand((8, 512, 512, 1), generator=torch.Generator().manual_seed(1)) > 0.1)
    batch = {"image": pages, "mask": holes.float().to(dev)}
    return lambda: step(state, batch)


def main() -> int:
    if not torch.cuda.is_available():
        print("host_syncs: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    pages = np.random.default_rng(0).uniform(0.0, 1.0, (8, 512, 512, 3)).astype(np.float32)
    pages = torch.from_numpy(pages).to(dev)
    if "--inpaint-step" in sys.argv[1:]:
        label, fn = "inpaint step", inpaint_step(dev, pages)
    else:
        pipe = TextRemovalPipeline().init_weights(torch.Generator().manual_seed(0)).to(dev).eval()
        label, fn = "run", lambda: pipe.run(pages)
    for _ in range(3):
        fn()
    control = blocking_calls(lambda: torch.tensor(0.5, device=dev))
    if not control:
        raise RuntimeError("the profiler recorded no blocking call for a blocking copy")
    calls = blocking_calls(fn)
    print(f"host_syncs: one {label} at (8, 512, 512, 3) bf16: {sum(calls.values())} blocking "
          f"calls {dict(calls)}; a blocking torch.tensor(..., device=cuda): {dict(control)}; "
          f"an empty window: {dict(blocking_calls(lambda: None))}")
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    print(f"host_syncs: {label} {ms:.3f} ms per batch of 8 = {8e3 / ms:.2f} pages/s (CUDA "
          f"events, median of {RUNS})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
