#!/usr/bin/env python3
"""Time the multi-device serving paths on one card, beside the plain ones.

On cuda:0 with random weights (seed 0), bf16, as ``chip_smoke.py``'s
parallel phase builds them: ``spatial_inpaint_unet`` on one 2048^2 page
(depth 8) over 2 and 4 bands beside the unsharded U-Net; ``pipeline2_run``
over 4 microbatches of 8 pages 512^2 on (cuda:0, cuda:0) beside
closed-loop ``run``; ``PageStreamServer`` over 20 batches of 8 uint8 pages
on a 2-entry mesh beside the plain server, its entries dispatched one
after the other (the server's way) and, as a comparison, each from a host
thread of its own. The bands run as ``parallel/spatial.py`` runs them
(their threads taking turns) and, as a comparison, all at once, meeting
at a barrier before each exchange. Each time is a median of CUDA-event times (the server:
wall time of the 20 batches), with torch.profiler's device busy time of
one call beside, the card's name and power limit on every line.

With ``--cards N`` (N >= 2) the meshes take distinct cards instead: the
bands on cuda:0..cuda:{bands-1}, the stages on (cuda:0, cuda:1), the
server on 2 and on N cards. Each result is then also checked against the
same path on one card (the bands, the stages and the server's halves
bit-equal).

    python3 tools/parallel_times.py [--iters 5] [--cards N]
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def events_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def busy_ms(fn) -> tuple:
    """(wall ms, device kernel ms) of one profiled call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, dev


def threaded_each(server):
    """The server's ``_each`` with every mesh entry dispatched from a host
    thread of its own (``torch.nn.parallel.parallel_apply``'s recipe, on
    the mesh's kept threads)."""
    from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import host_pool, on_stream

    def each(fn, dev):
        def work(pipe, stream, part, caller):
            with on_stream(stream.device, stream):
                stream.wait_stream(caller)
                part.record_stream(stream)
                return fn(pipe, part)

        futures = [host_pool().submit(work, pipe, stream, part,
                                      torch.cuda.current_stream(stream.device))
                   for (pipe, stream), part in zip(server._entries, dev)]
        outs = [f.result() for f in futures]
        return [o if isinstance(o, tuple) else (o,) for o in outs]

    server._each = each
    return server


@contextlib.contextmanager
def concurrent_bands():
    """The bands' threads all running at once, meeting at a barrier at
    each exchange, in place of ``parallel/spatial.py``'s turns."""
    from text_segmentation_image_inpainting_tpu_torch.parallel import spatial

    class BarrierRing(spatial._Ring):
        def __init__(self, n, timeout):
            super().__init__(n, timeout)
            self._barrier = threading.Barrier(n, timeout=timeout)
            self._arrived = [False] * n

        def pass_turn(self, i):
            self._arrived[i] = True

        def wait_turn(self, i):
            if self._arrived[i]:  # at an exchange; the start waits for nothing
                self._arrived[i] = False
                self._barrier.wait()

        def abort(self):
            self._barrier.abort()

    turns = spatial._Ring
    spatial._Ring = BarrierRing
    try:
        yield
    finally:
        spatial._Ring = turns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cards", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("parallel_times: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import BATCH, PAGE, SEED, SERVE_BATCHES, SPATIAL_PAGE, hole_mask
    from text_segmentation_image_inpainting_tpu_torch.data.pipeline import make_page_stream_u8
    from text_segmentation_image_inpainting_tpu_torch.parallel import (
        make_mesh,
        make_stage_mesh,
        pipeline2_run,
        spatial_inpaint_unet,
    )
    from text_segmentation_image_inpainting_tpu_torch.pipeline import (
        PageStreamServer,
        TextRemovalPipeline,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    if torch.cuda.device_count() < args.cards:
        print(f"parallel_times: {args.cards} cards asked, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    smi = f"{args.cards} x {smi}" if args.cards > 1 else smi

    def devices(n):
        """n mesh entries: cuda:0 n times, or n distinct cards."""
        return ([torch.device("cuda", i) for i in range(n)] if args.cards > 1
                else [dev] * n)

    def same(what, got, want):
        if args.cards > 1:
            ok = torch.equal(got.to(dev), want.to(dev))
            print(f"{what} on {args.cards} cards: bit-equal to one card {ok}", flush=True)
            if not ok:
                raise AssertionError(f"{what}: the cards' result differs from one card's")

    rng = np.random.default_rng(SEED)
    pipe = TextRemovalPipeline().init_weights(torch.Generator().manual_seed(SEED)).to(dev).eval()
    bf = torch.bfloat16

    def show(label, ms, fn, extra=""):
        wall, busy = busy_ms(fn)
        print(f"{label}: {ms:.3f} ms{extra}; profiled call wall {wall:.3f} ms, device kernels "
              f"{busy:.3f} ms ({busy / wall:.1%})  [{smi}]", flush=True)

    size = SPATIAL_PAGE
    page = torch.from_numpy(rng.uniform(0.0, 1.0, (1, size, size, 3)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(hole_mask(rng, 1, size, size)[..., None]).to(dev)
    x, m = (page * valid).to(bf), valid.to(bf)
    unet = pipe.unet
    with torch.no_grad():
        whole = events_ms(lambda: unet(x, m), args.iters)
        show(f"U-Net unsharded, {size}^2 page", whole, lambda: unet(x, m))
    for bands in (2, 4):
        mesh = make_mesh(devices=devices(bands))
        fn = lambda: spatial_inpaint_unet(mesh, unet, x, m)  # noqa: E731
        same(f"U-Net in {bands} bands", fn(),
             spatial_inpaint_unet(make_mesh(devices=[dev] * bands), unet, x, m))
        ms = events_ms(fn, args.iters)
        show(f"U-Net in {bands} bands, turns", ms, fn, f" ({ms / whole - 1:+.1%})")
        with concurrent_bands():
            ms = events_ms(fn, args.iters)
            show(f"U-Net in {bands} bands, all at once", ms, fn, f" ({ms / whole - 1:+.1%})")
    del page, valid, x, m

    pages_mb = torch.from_numpy(rng.uniform(0.0, 1.0, (4, BATCH, PAGE, PAGE, 3))
                                .astype(np.float32)).to(dev)
    stage = make_stage_mesh(devices(2))
    same("pipeline2", pipeline2_run(stage, pipe, pages_mb),
         torch.stack([pipe.run(p)[0] for p in pages_mb]))
    loop = lambda: [pipe.run(p) for p in pages_mb]  # noqa: E731
    piped = lambda: pipeline2_run(stage, pipe, pages_mb)  # noqa: E731
    t_loop = events_ms(loop, args.iters)
    t_pipe = events_ms(piped, args.iters)
    show("closed-loop run, 4 x 8 pages 512^2", t_loop, loop,
         f" = {4 * BATCH / t_loop * 1e3:.2f} pages/s")
    show(f"pipeline2 on {tuple(str(d) for d in stage.devices)}", t_pipe, piped,
         f" = {4 * BATCH / t_pipe * 1e3:.2f} pages/s ({t_pipe / t_loop - 1:+.1%})")

    stream = make_page_stream_u8(BATCH, (PAGE, PAGE), seed=SEED + 1)
    batches = [next(stream)["image"] for _ in range(SERVE_BATCHES)]
    meshes = {n: make_mesh(devices=devices(n)) for n in sorted({2, args.cards} - {1})}
    if args.cards > 1:
        from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import to_compute
        from text_segmentation_image_inpainting_tpu_torch.pipeline.sparse import to_uint8

        for n, mesh in meshes.items():
            got = list(PageStreamServer(pipe, depth=2, mesh=mesh).serve(iter(batches[:3])))
            for pages, (gc, _) in zip(batches, got):
                parts = [to_uint8(pipe.run(to_compute(torch.from_numpy(p).to(dev), bf))[0])
                         for p in np.split(pages, n)]
                same(f"DP serve over {n} entries", torch.from_numpy(gc), torch.cat(parts))

    def served(make):
        def go():
            for _ in make().serve(iter(batches)):
                pass
        return go

    variants = [("serve, depth 2", served(lambda: PageStreamServer(pipe, depth=2)))]
    for n, mesh in meshes.items():
        variants += [
            (f"DP serve, {n}-entry mesh, depth 2", served(
                lambda mesh=mesh: PageStreamServer(pipe, depth=2, mesh=mesh))),
            (f"DP serve, {n}-entry mesh, a host thread per entry", served(
                lambda mesh=mesh: threaded_each(PageStreamServer(pipe, depth=2, mesh=mesh)))),
        ]
    for label, fn in variants + variants[::-1]:
        fn()  # warm the pinned host blocks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        show(label, t * 1e3, fn, f" for {SERVE_BATCHES} batches of {BATCH} = "
             f"{SERVE_BATCHES * BATCH / t:.2f} pages/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
