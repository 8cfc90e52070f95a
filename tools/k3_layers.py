#!/usr/bin/env python3
"""K3 (the partial conv's backward) layer by layer, on one NVIDIA GPU.

For each of the eight stride-1 partial convs of ``InpaintUNet(depth=8)`` at
512^2 pages, batch 8, bf16 (``chip_smoke.py::SHAPES``), CUDA-event medians
of

  - ``partial_conv2d_backward`` as the U-Net's backward calls it,
  - autograd of the bf16 cuDNN twin (``_partial_conv2d_plain``),
  - one ``aten::convolution_backward`` on x already masked (the library's
    two products alone, never called by the port),
  - the stages of the plain version, each alone: the window count of the
    mask (msum), the scaled cotangent (dacc), the masked copy of x, the
    masked copy of dx, the two products and the bias gradient,
  - K3's own kernels, each alone, at Cout >= 8: ``k3_prep`` (dacc and db
    in one pass), ``k3_mask`` out of place (x * M) and in place (dx * M),

beside the least time the card could take (``chip_smoke.py::bound`` of
``pconv_bwd_work``: two products of the forward's size; x, g, the mask and
the weights read once, dx and dW written once). Then torch.profiler over the backward of
two layers (dec1 and the head by default): the device kernels by time and
the number of kernels launched per call.

    python3 tools/k3_layers.py [layer ...]
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def profile_kernels(fn, label: str, runs: int = 5) -> None:
    """The device kernels of ``fn`` by time, per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in rows) / 1e3 / runs
    count = sum(e.count for e in rows) / runs
    cs.log(f"profile K3 {label}: device time {total:.4f} ms in {count:.0f} kernels per call")
    for e in rows[:14]:
        cs.log(f"  {e.self_device_time_total / 1e3 / runs:8.4f} ms {e.count / runs:4.0f}x "
               f"{e.key[:100]}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("k3_layers: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from text_segmentation_image_inpainting_tpu_torch.ops.conv import to_nchw, to_nhwc
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import (
        _partial_conv2d_plain,
        apply_mask,
        mask_window_sum,
    )

    profiled = argv or ["dec1", "head"]
    dev = torch.device("cuda", 0)
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    bf = torch.bfloat16
    rng = np.random.default_rng(cs.SEED)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    tot = {}
    for name, h, c_lo, c_skip, cout in cs.SHAPES:
        cin = c_lo + c_skip
        x = torch.randn((cs.BATCH, h, h, cin), generator=gen, device=dev).to(bf)
        mask = cs.grouped_mask(rng, cs.BATCH, h, h, dev)
        w = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
             * (2.0 / (9 * cin)) ** 0.5).to(bf)
        b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(bf) if cout <= 7 else None
        g = torch.randn((cs.BATCH, h, h, cout), generator=gen, device=dev).to(bf)
        gs, pad = (c_lo, c_skip), (1, 1)

        def kern():
            return kpc.partial_conv2d_backward(g, x, mask, w, b, gs, pad)

        leaves = [t.detach().requires_grad_(True) for t in (x, w, b) if t is not None]
        y, _ = _partial_conv2d_plain(leaves[0], mask, leaves[1],
                                     leaves[2] if b is not None else None, gs, (1, 1), pad, (1, 1))

        def twin():
            return torch.autograd.grad(y, leaves, g, retain_graph=True)

        # the plain version's stages, each alone on this layer's tensors
        msum = mask_window_sum(mask, gs, (3, 3), stride=(1, 1), padding=pad)
        valid = msum > 0
        scale = torch.where(valid, float(9 * cin) / torch.clamp(msum, min=1.0), 0.0)
        dacc = to_nchw((g.float() * scale).to(bf))
        xm = to_nchw(apply_mask(x, mask, gs))
        dxm = torch.nn.grad.conv2d_input((cs.BATCH, cin, h, h), w, dacc, padding=pad)
        stages = {
            "msum": lambda: mask_window_sum(mask, gs, (3, 3), stride=(1, 1), padding=pad),
            "dacc": lambda: to_nchw((g.float() * torch.where(
                valid, float(9 * cin) / torch.clamp(msum, min=1.0), 0.0)).to(bf)),
            "x*M": lambda: apply_mask(x, mask, gs),
            "dx*M": lambda: apply_mask(to_nhwc(dxm), mask, gs),
            "dgrad": lambda: torch.nn.grad.conv2d_input((cs.BATCH, cin, h, h), w, dacc,
                                                        padding=pad),
            "wgrad": lambda: torch.nn.grad.conv2d_weight(xm, w.shape, dacc, padding=pad),
            "db": lambda: (g.float() * valid).sum(dim=(0, 1, 2)).to(bf),
            "library": lambda: torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), xm, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [True, True, False]),
        }
        if cout > 7:
            dxn = to_nhwc(dxm)
            stages.update({
                "k3_prep": lambda: kpc.k3_prep(g, mask, cin, gs, 3, 1),
                "k3_mask x": lambda: kpc.k3_mask(x, mask, gs),
                "k3_mask dx": lambda: kpc.k3_mask(dxn, mask, gs, out=dxn),
            })
        b_ms, b_by = cs.bound(*cs.pconv_bwd_work(x, mask, w, g))
        row = {"K3": (cs.cuda_ms(kern) + cs.cuda_ms(kern)) / 2, "twin": cs.cuda_ms(twin)}
        row.update({k: cs.cuda_ms(fn) for k, fn in stages.items()})
        row["bound"] = b_ms
        cs.log(f"K3 {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
               + f" ms (bound by {b_by})")
        for k, v in row.items():
            tot[k] = tot.get(k, 0.0) + v
        if name in profiled:
            profile_kernels(kern, name)
        del y, leaves, xm, dxm, dacc, stages
    cs.log("K3 sum over the 8 layers: " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items())
           + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
