#!/usr/bin/env python3
"""Where K6 (the depthwise weight gradient) spends its time, phase by
phase, on one NVIDIA GPU.

The card's machine runs no ncu or nsys, so this script builds copies of
``csrc/depthwise_wgrad.cu``:

  - one with ``clock64()`` read by thread 0 of every CTA at the end of each
    phase, summed over the CTAs with atomics: per step of G rows, the
    barrier (the wait for the slowest warp of the last step), the issue of
    the TMA rows PRE steps ahead, the wait for this step's rows on its
    mbarrier, and the sums; per CTA, the prologue, the butterfly and warps'
    sums into the CTA's slot, and the last CTA's sum over the slots;
  - copies timed with torch.profiler beside the kernel: one that loads
    every row but sums nothing ("loads only"), one that sums the ring as
    the prologue left it and loads nothing more ("sums only"), and the
    kernel with other steps (G rows) and depths (PRE steps ahead). Their device times bound what the memory pipeline and the
    arithmetic take alone.

At the five shapes of one seg train step (``chip_smoke.py::SEG_SHAPES``).
The atomics cost a few percent; time the kernel with ``chip_smoke.py``.

    python3 tools/k6_phase_clocks.py
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

import torch
from phase_clocks import CSRC, PRELUDE, START, build_copy, card, cycles, patch

CU = "depthwise_wgrad.cu"
STEP_PHASES = {1: "barrier: the slowest warp of the last step", 2: "issue the TMA rows PRE steps ahead",
               3: "wait for the step's rows (mbarrier)", 4: "sums of the step"}
CTA_PHASES = {0: "prologue (PRE steps issued)", 5: "butterfly, warps' sums, the CTA's slot",
              7: "last CTA: its ticket", 6: "last CTA: the slots in order"}
WAIT = "    if (tma) mbar_wait(&bars[s % NBAR], (s / NBAR) & 1);\n"


def source() -> str:
    return (CSRC / CU).read_text()


def instrumented() -> str:
    src = source()
    src = patch(src, "namespace {\n", PRELUDE + "namespace {\n")
    anchor = "  unsigned char* gs = smem + (size_t)nxs * xsb;"
    src = patch(src, anchor, START + " if (threadIdx.x == 0) { atomicAdd(&g_clk[31], "
                "(unsigned long long)steps); atomicAdd(&g_clk[30], 1ull); }\n" + anchor)
    src = patch(src, "  for (int s = 0; s < PRE; ++s) issue(s);\n",
                "  for (int s = 0; s < PRE; ++s) issue(s);\n  CLK(0);\n")
    src = patch(src, "    issue(s + PRE);\n" + WAIT,
                "    CLK(1);\n    issue(s + PRE);\n    CLK(2);\n" + WAIT + "    CLK(3);\n")
    src = patch(src, "      }\n    }\n  }\n  __syncthreads();  // the rings are dead",
                "      }\n    }\n    CLK(4);\n  }\n  __syncthreads();  // the rings are dead")
    src = patch(src, "  // the last CTA of this channel block adds the slots in slot order.",
                "  CLK(5);\n  // the last CTA of this channel block adds the slots in slot order.")
    src = patch(src, "  const float* all = partial", "  CLK(7);\n  const float* all = partial")
    src = patch(src, "  if (t == 0) tickets[cb] = 0u;", "  CLK(6);\n  if (t == 0) tickets[cb] = 0u;")
    return src


def loads_only() -> str:  # PRELUDE: the clock sums that every copy's reader reads
    return PRELUDE + patch(source(), "    if (!live || ro >= nrows) continue;\n",
                           "    if (!live || ro >= nrows || h > 0) continue;\n")


def sums_only() -> str:  # the prologue's rows only, summed as if they were every step's
    return PRELUDE + patch(source(), "    issue(s + PRE);\n" + WAIT,
                           "    if (tma && s == 0) mbar_wait(&bars[0], 0);\n")


def constants(g: int, pre: int):
    """The kernel with G rows a step and PRE steps ahead (the same ring)."""
    return lambda: PRELUDE + patch(patch(source(), "constexpr int G = 4;", f"constexpr int G = {g};"),
                                   "constexpr int PRE = 1;", f"constexpr int PRE = {pre};")


# timed beside the kernel: the two halves alone, and other steps and depths
VARIANTS = {"loads only": loads_only, "sums only": sums_only, "G 2, PRE 3": constants(2, 3),
            "G 4, PRE 2": constants(4, 2)}


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw

    others = [p for p in sorted(CSRC.glob("*.cu")) if p.name != CU]
    copies = {"clocks": instrumented, **VARIANTS}
    with ThreadPoolExecutor(len(copies)) as pool:  # one nvcc each, side by side
        libs = dict(zip(copies, pool.map(
            lambda item: build_copy(f"k6_{abs(hash(item[0]))}", item[1](), others), copies.items())))
    print(card())
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)
    shapes = []
    for name, h, c, d, count in cs.SEG_SHAPES:
        x = torch.randn((cs.BATCH, h, h, c), generator=gen, device=dev).to(bf)
        dy = torch.randn((cs.BATCH, h, h, c), generator=gen, device=dev).to(bf)
        shapes.append((name, x, dy, d, count))

    real, times = build.build_library, {}
    names = ["kernel", *VARIANTS]
    for variant in names:
        build._lib = None
        build.build_library = real if variant == "kernel" else (lambda path=libs[variant]: path)
        build.load_library()
        for name, x, dy, d, count in shapes:
            times[variant, name] = cs.device_ms(lambda: kdw.depthwise_wgrad(x, dy, 3, d), "dw_wgrad")
    print("device ms per launch: " + " / ".join(names))
    tot = [0.0] * len(names)
    for name, x, dy, d, count in shapes:
        t = [times[v, name] for v in names]
        print(f"  {name} {tuple(x.shape)} d {d}: " + " / ".join(f"{v:.4f}" for v in t)
              + f"  (x{count} per step)")
        tot = [a + count * b for a, b in zip(tot, t)]
    print("  one seg step's 14 launches: " + " / ".join(f"{v:.4f}" for v in tot))

    # the kernel under other bands (k6_plan's choice marked *)
    build._lib = None
    build.build_library = real
    build.load_library()
    chosen = kdw.k6_plan
    try:
        for name, x, dy, d, count in shapes:
            n, h, w, c = x.shape
            best = chosen(n, h, w, c, 3, d, 2, kdw._sm_count(0))
            cells = []
            for bands in (1, 2, 3, 4, 6, 8):
                rows = -(-h // bands)
                plan = best._replace(rows=rows, bands=-(-h // rows))
                kdw.k6_plan = lambda *a, plan=plan: plan
                ms = cs.device_ms(lambda: kdw.depthwise_wgrad(x, dy, 3, d), "dw_wgrad")
                cells.append(f"{plan.bands} {ms:.4f}{'*' if rows == best.rows else ''}")
            print(f"  {name}, bands: " + ", ".join(cells))
    finally:
        kdw.k6_plan = chosen

    build._lib = None
    build.build_library = lambda path=libs["clocks"]: path
    lib = build.load_library()
    for name, x, dy, d, count in shapes:
        plan = kdw.k6_plan(*x.shape, 3, d, 2, kdw._sm_count(0))
        v = cycles(lib, lambda: kdw.depthwise_wgrad(x, dy, 3, d))
        steps, ctas = max(v[31], 1), max(v[30], 1)
        print(f"{name} {tuple(x.shape)} d {d}, {plan}: {v[30]} CTAs, {v[31]} steps of "
              f"{kdw.K6_G} rows; thread 0's cycles per step:")
        for k, label in STEP_PHASES.items():
            print(f"    {label:44s} {v[k] / steps:9.0f}")
        print("  per CTA:")
        for k, label in CTA_PHASES.items():  # one last CTA per channel block
            print(f"    {label:44s} {v[k] / (plan.cblocks if k in (6, 7) else ctas):9.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
