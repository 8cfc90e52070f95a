#!/usr/bin/env python3
"""The general forms of the Cout <= 7 partial conv and of K6, per kernel,
on one NVIDIA GPU.

At shapes that only the general forms take (``CASES``: the U-Net head's
67 -> 3 on 8 pages of 512^2 at k 11 and 13, and three mask groups (24,
16, 8) at Cout 3, k 3, on the same pages), in bf16 and f32, the
CUDA-event median and each device kernel's time (torch.profiler) of

  - the forward, ``partial_conv2d_fused`` (``pconv_gen_relay``,
    ``pconv_gen_rowsum``, ``pconv_gen_fwd_bf16`` / ``pconv_gen_fwd_f32``),
  - the backward, ``partial_conv2d_backward`` (``pconv_k3_prep``,
    ``pconv_gen_relay``, ``pconv_gen_dx_bf16`` / ``_f32``,
    ``pconv_gen_dw_bf16`` / ``_f32``,
    ``pconv_colsum``),
  - cuDNN's conv on x already masked and its ``convolution_backward`` in
    the same dtype (TF32 off; yardsticks the port never calls),
  - and the bound of each (``chip_smoke.py::bound``: operations at the
    dtype's peak or bytes at 3.35 TB/s, the larger; K6's operations are
    ``chip_smoke.py::k6_work``'s, the products inside the image);

then, for the routing cut (``ROUTE_CASES``: the head's 67 -> 3 at k 3 and
5 to 11), wherever the plans pick a templated form (K2,
``pconv_k2_bwd``, K2F, ``pconv_k2f_bwd``), that form beside the general
form forced on the same inputs (``_launch_gen_fwd`` / ``_launch_gen_bwd``); and
K6's general form (``dw_wgrad_gen_tiles``, ``dw_wgrad_gen_fold``) at
``K6_CASES`` (k 9 on the segmenter's block-2 map (8, 128, 128, 144) and
``chip_smoke.py``'s SCOPE_K6) beside cuDNN's depthwise wgrad and the bound;
with the card's name and power limit. Each line names the form the plans
pick; where that is the templated one, the general form forced on the same
inputs follows it.

    python3 tools/gen_forms.py [--quick | --no-route | --k6 | --k6-route]

``--quick`` times only ``CASES``' first entry, ``--no-route`` only
``CASES``, ``--k6`` only K6 at ``K6_CASES``. ``--k6-route`` weighs K6's
templated form against its general form forced on the same inputs at the
shapes near the template's limits (``K6_ROUTE``: k 3 at d 8 to 27, k 5 at
d 4 to 13, k 7 at d 2 to 9 on block 2's map, and K6_RAGGED's d 20 strips),
both dtypes, each with its plan, the two results' largest difference and
the ratio general / templated: the routing cut ``K6_GEN_HALO`` comes from
it. The script also runs in an older tree for an A/B (copy it there, with
this tree's ``chip_smoke.py``, whose ``bound`` and ``k6_work`` it imports);
there ``--k6`` reads the older plan's fields.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (name, N, H, W, group sizes, Cout, k, padding)
CASES = (
    ("head 67 -> 3, k 11", 8, 512, 512, (64, 3), 3, 11, (5, 5)),
    ("head 67 -> 3, k 13", 8, 512, 512, (64, 3), 3, 13, (6, 6)),
    ("G 3 (24, 16, 8) -> 3, k 3", 8, 512, 512, (24, 16, 8), 3, 3, (1, 1)),
)
ROUTE_CASES = tuple(
    (f"head 67 -> 3, k {k}", 8, 512, 512, (64, 3), 3, k, ((k - 1) // 2, (k - 1) // 2))
    for k in (3, 5, 6, 7, 8, 9, 10, 11))
K6_CASES = (("K6 k 9, block 2", 8, 128, 128, 144, 9, 1),
            ("K6 k 9, d 1", 2, 64, 64, 128, 9, 1),
            ("K6 k 7, d 48", 2, 96, 96, 128, 7, 48),
            ("K6 k 13, d 2, C 130", 2, 64, 64, 130, 13, 2),
            ("K6 k 3, d 25, block 2", 8, 128, 128, 144, 3, 25))
K6_ROUTE = tuple((f"K6 k {k}, d {d}, block 2", 8, 128, 128, 144, k, d) for k, ds in (
    (3, (8, 12, 16, 20, 24, 25, 26, 27)), (5, (4, 6, 8, 10, 12, 13)), (7, (2, 3, 4, 5, 6, 7, 8, 9)))
    for d in ds) + (("K6 k 3, d 20, 50x100, C 128 (K6_RAGGED)", 1, 50, 100, 128, 3, 20),)


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


def show(label: str, fn) -> float:
    ms, per_kernel = event_ms(fn), kernel_ms(fn)
    parts = ", ".join(f"{short(k)} {v:.4f}" for k, v in
                      sorted(per_kernel.items(), key=lambda kv: -kv[1]))
    print(f"{label}: {ms:.4f} ms (events); device: {parts}", flush=True)
    return ms


def inputs(gen, dev, n, h, w, groups, cout, k):
    cin = sum(groups)
    x = torch.randn((n, h, w, cin), generator=gen, device=dev)
    m = (torch.rand((n, h, w, len(groups)), generator=gen, device=dev) < 0.6).float()
    wt = torch.randn((cout, cin, k, k), generator=gen, device=dev) / (k * k * cin) ** 0.5
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    return x, m, wt, b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="CASES' first entry only")
    ap.add_argument("--no-route", action="store_true",
                    help="CASES only: no routing comparison, no K6 (for an A/B)")
    ap.add_argument("--k6", action="store_true", help="K6 at K6_CASES only (for an A/B)")
    ap.add_argument("--k6-route", action="store_true",
                    help="K6's templated form beside its general form forced, at K6_ROUTE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gen_forms: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import PEAK_BF16, PEAK_F32, bound, k6_work
    from text_segmentation_image_inpainting_tpu_torch.ops.conv import to_nchw
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import load_library
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import apply_mask

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"gen_forms: {smi}; torch {torch.__version__}; tree {ROOT}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = load_library()
    if args.k6_route:
        return k6_route(dev, gen)
    cases = (() if args.k6 else CASES[:1] if args.quick else CASES if args.no_route
             else CASES + ROUTE_CASES)
    for ci, (name, n, h, w, groups, cout, k, pad) in enumerate(cases):
        cin = sum(groups)
        x, m, wt, b = inputs(gen, dev, n, h, w, groups, cout, k)
        for dt in (torch.bfloat16, torch.float32):
            f32 = dt == torch.float32
            label = f"{name} {'f32' if f32 else 'bf16'}"
            xd, md, wd, bd = (t.to(dt) for t in (x, m, wt, b))
            fwd_general = (kpc.k2f_plan(n, h, w, cin, cout, k, pad, len(groups)).general if f32
                           else kpc.k2_general(cin, cout, k, len(groups)))
            bwd_general = (kpc.k2f_bwd_plan(n, h, w, cin, cout, k, len(groups)).general if f32
                           else kpc.k2_general(cin, cout, k, len(groups), pad, True))
            routing = ci >= len(CASES)
            if routing and fwd_general and bwd_general:
                continue  # nothing templated to weigh the general form against
            kw = dict(group_sizes=groups, padding=pad)
            needs = (True, True, True)
            y, m_out = kpc.partial_conv2d_fused(xd, md, wd, bd, **kw)
            g = torch.randn(y.shape, generator=gen, device=dev).to(dt)
            b32, yg, mg = bd.float(), torch.empty_like(y), torch.empty_like(m_out)
            form = lambda general: "general" if general else "templated"  # noqa: E731
            t_f = show(f"{label} forward ({form(fwd_general)})",
                       lambda: kpc.partial_conv2d_fused(xd, md, wd, bd, **kw))
            if not fwd_general:
                t_g = show(f"{label} forward (general, forced)", lambda: kpc._launch_gen_fwd(
                    lib, xd, md, wd, b32, yg, mg, groups, pad))
                print(f"{label} forward: general / templated {t_g / t_f:.3f}", flush=True)
            t_b = show(f"{label} backward ({form(bwd_general)})",
                       lambda: kpc.partial_conv2d_backward(g, xd, md, wd, bd, groups, pad, needs))
            if not bwd_general:
                t_g = show(f"{label} backward (general, forced)", lambda: kpc._launch_gen_bwd(
                    g, xd, md, wd, bd, groups, pad, needs))
                print(f"{label} backward: general / templated {t_g / t_b:.3f}", flush=True)
            if routing:
                continue
            xm = to_nchw(apply_mask(xd, md, groups))
            wl = wd.contiguous(memory_format=torch.channels_last)
            gl = to_nchw(g)
            lib_f = lambda: torch.nn.functional.conv2d(xm, wl, padding=pad)  # noqa: E731
            lib_b = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
                gl, xm, wl, None, [1, 1], list(pad), [1, 1], False, [0, 0], 1,
                [True, True, False])
            print(f"{label} cuDNN: conv {event_ms(lib_f):.4f} ms, convolution_backward "
                  f"{event_ms(lib_b):.4f} ms (events, {dt})", flush=True)
            elem, p_out = xd.element_size(), y.shape[0] * y.shape[1] * y.shape[2]
            flop = 2.0 * p_out * cout * k * k * cin
            fbytes = elem * (xd.numel() + md.numel() + wd.numel() + p_out * cout + p_out)
            bbytes = elem * (2 * xd.numel() + g.numel() + md.numel() + 2 * wd.numel())
            peak = PEAK_F32 if f32 else PEAK_BF16
            (bf, byf), (bb, byb) = bound(flop, fbytes, peak), bound(2 * flop, bbytes, peak)
            print(f"{label} bound: forward {bf:.4f} ms ({byf}), backward {bb:.4f} ms ({byb})",
                  flush=True)
    if args.quick or args.no_route:
        return 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, n, h, w, c, k, d in K6_CASES:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
            dy = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
            plan = kdw.k6_plan(n, h, w, c, k, d, x.element_size(), sms)
            cut = getattr(plan, "gen", None)
            if cut is None:  # an older tree: chunks of pixels, or the templated form
                cut = (f"{plan.chunks} chunks" if plan.general
                       else f"templated, strips {plan.strips} of {plan.tw}")
            label = f"{name} {'f32' if dt == torch.float32 else 'bf16'}"
            show(f"{label} ({cut})", lambda: kdw.depthwise_wgrad(x, dy, k, d))
            p = d * (k - 1) // 2
            wdw = torch.zeros((c, 1, k, k), device=dev, dtype=dt)
            xc, dyc = to_nchw(x), to_nchw(dy)
            lib_w = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
                dyc, xc, wdw, None, [1, 1], [p, p], [d, d], False, [0, 0], c,
                [False, True, False])
            flop, nbytes = k6_work(x, k, d)
            t_b, by = bound(flop, nbytes, PEAK_F32 if dt == torch.float32 else PEAK_BF16)
            print(f"{label} cuDNN's depthwise wgrad {event_ms(lib_w):.4f} ms (events); bound "
                  f"{t_b:.4f} ms ({by}); FFMA floor {flop / PEAK_F32 * 1e3:.4f} ms", flush=True)
    return 0


def k6_route(dev, gen) -> int:
    """K6's templated form beside its general form forced, at K6_ROUTE."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, n, h, w, c, k, d in K6_ROUTE:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
            dy = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
            label = f"{name} {'f32' if dt == torch.float32 else 'bf16'}"
            plan = kdw.k6_plan(n, h, w, c, k, d, x.element_size(), sms)
            forced = kdw.k6_gen_plan(n, h, w, c, k, d, x.element_size(), sms)
            if plan.general:
                print(f"{label}: the plan takes the general form ({plan.gen})", flush=True)
                continue
            a, b = kdw._launch_k6(x, dy, k, d), kdw._launch_k6_gen(x, dy, k, d, forced)
            diff = (a - b).abs().max().item()
            t_t = event_ms(lambda: kdw._launch_k6(x, dy, k, d))
            t_g = event_ms(lambda: kdw._launch_k6_gen(x, dy, k, d, forced))
            print(f"{label}: templated {t_t:.4f} ms (strips {plan.strips} of {plan.tw}, bands "
                  f"{plan.bands}), general forced {t_g:.4f} ms ({forced}); general / "
                  f"templated {t_g / t_t:.3f}; max |templated - general| {diff:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
