#!/usr/bin/env python3
"""The general forms of the Cout <= 7 partial conv and of K6, per kernel,
on one NVIDIA GPU.

At shapes that only the general forms take (``CASES``: the U-Net head's
67 -> 3 on 8 pages of 512^2 at k 13, and three mask groups (24, 16, 8) at
Cout 3, k 3, on the same pages), in bf16 and f32, the CUDA-event median
and each device kernel's time (torch.profiler) of

  - the forward, ``partial_conv2d_fused`` (``pconv_gen_fwd``),
  - the backward, ``partial_conv2d_backward`` (``pconv_k3_prep``,
    ``pconv_gen_dx``, ``pconv_gen_dw``, ``pconv_colsum``),
  - cuDNN's conv on x already masked and its ``convolution_backward``
    (TF32 off; yardsticks the port never calls);

and K6's general form (``dw_wgrad_gen``, ``dw_wgrad_gen_sum``) at k 9 on
the segmenter's block-2 map (8, 128, 128, 144) beside cuDNN's depthwise
wgrad; with the card's name and power limit. Every case first asserts that
the plan picks the general form.

    python3 tools/gen_forms.py
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (name, N, H, W, group sizes, Cout, k, padding)
CASES = (
    ("head 67 -> 3, k 13", 8, 512, 512, (64, 3), 3, 13, (6, 6)),
    ("G 3 (24, 16, 8) -> 3, k 3", 8, 512, 512, (24, 16, 8), 3, 3, (1, 1)),
)
K6_CASE = ("K6 k 9, block 2", 8, 128, 128, 144, 9, 1)


def event_ms(fn, iters: int = 10, warmup: int = 3) -> float:
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


def kernel_ms(fn, runs: int = 5) -> dict:
    """Device milliseconds per call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / runs for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def short(key: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0][:60]


def show(label: str, ms: float, per_kernel: dict) -> None:
    parts = ", ".join(f"{short(k)} {v:.4f}" for k, v in
                      sorted(per_kernel.items(), key=lambda kv: -kv[1]))
    print(f"{label}: {ms:.4f} ms (events); device: {parts}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("gen_forms: no CUDA device", file=sys.stderr)
        return 2
    from text_segmentation_image_inpainting_tpu_torch.ops.conv import to_nchw
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import apply_mask

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"gen_forms: {smi}; torch {torch.__version__}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, n, h, w, groups, cout, k, pad in CASES:
        cin = sum(groups)
        x = torch.randn((n, h, w, cin), generator=gen, device=dev)
        m = (torch.rand((n, h, w, len(groups)), generator=gen, device=dev) < 0.6).float()
        wt = torch.randn((cout, cin, k, k), generator=gen, device=dev) / (k * k * cin) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        for dt in (torch.bfloat16, torch.float32):
            f32 = dt == torch.float32
            label = f"{name} {'f32' if f32 else 'bf16'}"
            xd, md, wd, bd = (t.to(dt) for t in (x, m, wt, b))
            fwd_general = (kpc.k2f_plan(n, h, w, cin, cout, k, pad, len(groups)).general if f32
                           else kpc.k2_general(cin, cout, k, len(groups)))
            bwd_general = (kpc.k2f_bwd_plan(n, h, w, cin, cout, k, len(groups)).general if f32
                           else kpc.k2_general(cin, cout, k, len(groups), pad, True))
            assert fwd_general and bwd_general, (label, fwd_general, bwd_general)
            kw = dict(group_sizes=groups, padding=pad)
            y, _ = kpc.partial_conv2d_fused(xd, md, wd, bd, **kw)
            g = torch.randn(y.shape, generator=gen, device=dev).to(dt)
            fwd = lambda: kpc.partial_conv2d_fused(xd, md, wd, bd, **kw)  # noqa: E731
            bwd = lambda: kpc.partial_conv2d_backward(  # noqa: E731
                g, xd, md, wd, bd, groups, pad, (True, True, True))
            show(f"{label} forward", event_ms(fwd), kernel_ms(fwd))
            show(f"{label} backward", event_ms(bwd), kernel_ms(bwd))
            xm = to_nchw(apply_mask(xd, md, groups))
            wl = wd.contiguous(memory_format=torch.channels_last)
            gl = to_nchw(g)
            lib_f = lambda: torch.nn.functional.conv2d(xm, wl, padding=pad)  # noqa: E731
            lib_b = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
                gl, xm, wl, None, [1, 1], list(pad), [1, 1], False, [0, 0], 1,
                [True, True, False])
            print(f"{label} cuDNN: conv {event_ms(lib_f):.4f} ms, convolution_backward "
                  f"{event_ms(lib_b):.4f} ms (events)", flush=True)
    name, n, h, w, c, k, d = K6_CASE
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
        dy = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
        plan = kdw.k6_plan(n, h, w, c, k, d, x.element_size(), sms)
        assert plan.general, plan
        label = f"{name} {'f32' if dt == torch.float32 else 'bf16'} ({plan.chunks} chunks)"
        fn = lambda: kdw.depthwise_wgrad(x, dy, k, d)  # noqa: E731
        show(label, event_ms(fn), kernel_ms(fn))
        p = d * (k - 1) // 2
        wdw = torch.zeros((c, 1, k, k), device=dev, dtype=dt)
        xc, dyc = to_nchw(x), to_nchw(dy)
        lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            dyc, xc, wdw, None, [1, 1], [p, p], [d, d], False, [0, 0], c, [False, True, False])
        print(f"{label} cuDNN's depthwise wgrad {event_ms(lib):.4f} ms (events)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
