#!/usr/bin/env python3
"""Hash K1's and K2's outputs at the U-Net's 8 stride-1 layers, and the
head's backward (K3 in bf16, and K2F and K3F's head in f32), on the card.

The inputs are ``chip_smoke.py``'s parity cases (``SHAPES`` at 512^2,
batch 8, padding (1, 1), the same generator seeds), so two source trees
give the same inputs. Run it in each tree, in one call, and compare the
hashes: equal hashes mean the kernels' bytes (y and M'; dx, dW and db)
are identical.

    python3 tools/pconv_bits.py [--out FILE] [--time]

Prints one line per layer and, last, a JSON object {layer: sha256 of
y's and M''s bytes}; ``--out`` also writes that object to FILE. With
``--time`` each layer's line also gives the call's CUDA-event median (20
calls after 3, bf16 weights as the U-Net passes them) and the kernels'
device time (torch.profiler), and a line sums them over the 7 K1 levels,
with the card's name and power limit: run it in two trees in turns (old,
new, new, old) for an A/B of the same kernels.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def device_ms(fn, runs: int = 10) -> float:
    """Device milliseconds per call of the kernels ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pconv_bits: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import BATCH, SEED, SHAPES, grouped_mask
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hashes, sums = {}, {"events": 0.0, "device": 0.0}
    if args.time:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        print(f"pconv_bits: {smi}; {ROOT}", flush=True)
    for name, h, c_lo, c_skip, cout in SHAPES:
        cin = c_lo + c_skip
        x = torch.randn((BATCH, h, h, cin), generator=gen, device=dev).to(torch.bfloat16)
        mask = grouped_mask(rng, BATCH, h, h, dev)
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1 if cout <= 7 else None
        y, m = kpc.partial_conv2d_fused(x, mask, w, b, group_sizes=(c_lo, c_skip), padding=(1, 1))
        digest = hashlib.sha256()
        for t in (y, m):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        hashes[name] = digest.hexdigest()
        timing = ""
        if args.time:
            wb = w.to(torch.bfloat16)
            call = lambda: kpc.partial_conv2d_fused(  # noqa: E731
                x, mask, wb, b, group_sizes=(c_lo, c_skip), padding=(1, 1))
            ev, dv = event_ms(call), device_ms(call)
            timing = f"; {ev:.4f} ms (events), device {dv:.4f} ms"
            if cout > 7:
                sums["events"] += ev
                sums["device"] += dv
        print(f"{name}: y {tuple(y.shape)} {hashes[name]}{timing}", flush=True)
        if cout <= 7:  # the head's backward (bf16), and its f32 forward and backward
            g = torch.randn(y.shape, generator=gen, device=dev)
            outs = {f"{name} backward": kpc.partial_conv2d_backward(
                g.to(torch.bfloat16), x, mask, w.to(torch.bfloat16), b, (c_lo, c_skip), (1, 1))}
            xf, mf = x.float(), mask.float()
            outs[f"{name} f32"] = kpc.partial_conv2d_fused(
                xf, mf, w, b, group_sizes=(c_lo, c_skip), padding=(1, 1))
            outs[f"{name} f32 backward"] = kpc.partial_conv2d_backward(
                g, xf, mf, w, b, (c_lo, c_skip), (1, 1))
            for key, ts in outs.items():
                digest = hashlib.sha256()
                for t in ts:
                    digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
                hashes[key] = digest.hexdigest()
                print(f"{key}: {hashes[key]}", flush=True)
    if args.time:
        print(f"K1 over the 7 levels: {sums['events']:.4f} ms (events), device "
              f"{sums['device']:.4f} ms", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(hashes, indent=1))
    print(json.dumps(hashes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
