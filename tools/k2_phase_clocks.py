#!/usr/bin/env python3
"""Where the RGB head's kernels spend their time, phase by phase, on one
NVIDIA GPU.

The card's machine runs no ncu or nsys, so this script builds a copy of
``csrc/partial_conv.cu`` with ``clock64()`` read by thread 0 of every CTA
after each ``__syncthreads()`` of ``pconv_k2`` (the head's forward) and of
``pconv_k2_bwd``'s tile loop, summed over the CTAs with atomics, and prints
the cycles per tile of each phase at the head's shape (8 x 512 x 512, 67 ->
3). A phase ends at a barrier, so it includes the wait for the slowest
warp. The copy is loaded in place of the package's library, so the
wrappers of ``ops/kernels/partial_conv.py`` drive it. The atomics cost a few
percent; time the kernels with ``chip_smoke.py``, not with this.

    python3 tools/k2_phase_clocks.py
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from phase_clocks import CSRC, PRELUDE, START, build_copy, card, cycles, marked, patch, report

SYNC = "__syncthreads();"
FWD_PHASES = {0: "halo pixels and masks", 1: "window counts, stage x and W (cp.async)",
              2: "re-lay x * M", 3: "products (mma.sync)", 4: "epilogue into the y rows",
              5: "y rows to device memory"}
BWD_PHASES = {10: "dx rows to device memory (previous tile)", 11: "masks around the tile",
              12: "window counts, dacc over the halo", 13: "stage x (cp.async), D rows",
              14: "re-lay x * M", 19: "dx product and its masked rows", 15: "dW product"}


def instrumented() -> str:
    src = (CSRC / "partial_conv.cu").read_text()
    src = patch(src, '#include "sm90.cuh"\n', '#include "sm90.cuh"\n' + PRELUDE)
    a = src.index("__global__ void __launch_bounds__(K2_THREADS, 3) pconv_k2(const Params p)")
    b = src.index("template <int NKB>\ncudaError_t launch_k2(const Params& p, cudaStream_t stream)")
    fwd = patch(src[a:b], "  // the halo's pixels and masks (0 outside the image)\n",
                START + " if (threadIdx.x == 0) atomicAdd(&g_clk[31], 1ull);\n")
    fwd = marked(fwd, SYNC, 0)
    fwd = patch(fwd, "  if (oh >= p.hout || ow0 >= p.wout) return;\n",
                "  if (oh >= p.hout || ow0 >= p.wout) return;\n  const int clk_tail_ = 1;\n")
    # the row stores of warp 0 end thread 0's last phase
    fwd = patch(fwd, "    for (int i = lane; i < ne; i += 32) dst[i] = src[i];\n  }\n}",
                "    for (int i = lane; i < ne; i += 32) dst[i] = src[i];\n  }\n"
                "  if (clk_tail_) { CLK(5); }\n}")
    src = src[:a] + fwd + src[b:]
    a = src.index("    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {")
    b = src.index("    // this pass's dW: the four pixel groups' parts added in order")
    loop = marked(src[a:b], SYNC, 10)
    loop = patch(loop, "      if (p.need_dw && j0 < kj) {\n        // dW[j, c] +=",
                 "      CLK(19);\n      if (p.need_dw && j0 < kj) {\n        // dW[j, c] +=")
    loop = patch(loop, "      const int ih0 = ty * K2_TH, iw0 = tx * K2_TW;\n",
                 "      const int ih0 = ty * K2_TH, iw0 = tx * K2_TW;"
                 " if (threadIdx.x == 0) atomicAdd(&g_clk[30], 1ull);\n")
    src = src[:a] + loop + src[b:]
    src = patch(src, "  const int njb = (kj + K2_JB - 1) / K2_JB;\n",
                "  const int njb = (kj + K2_JB - 1) / K2_JB;\n" + START + "\n")
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    others = [p for p in sorted(CSRC.glob("*.cu")) if p.name != "partial_conv.cu"]
    lib_path = build_copy("k2_phase_clocks", instrumented(), others)
    build.build_library = lambda: lib_path  # the wrappers now load the instrumented copy
    lib = build.load_library()

    dev, bf = torch.device("cuda"), torch.bfloat16
    print(card())
    gen = torch.Generator(dev).manual_seed(0)
    name, h, c_lo, c_skip, cout = cs.SHAPES[-1]
    cin = c_lo + c_skip
    x = torch.randn((cs.BATCH, h, h, cin), generator=gen, device=dev).to(bf)
    mask = cs.grouped_mask(np.random.default_rng(0), cs.BATCH, h, h, dev)
    w = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5).to(bf)
    b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(bf)
    g = torch.randn((cs.BATCH, h, h, cout), generator=gen, device=dev).to(bf)
    gs, pad = (c_lo, c_skip), (1, 1)
    launch = {
        "pconv_k2": lambda: kpc.partial_conv2d_fused(x, mask, w, b, group_sizes=gs, padding=pad),
        "pconv_k2_bwd": lambda: kpc.partial_conv2d_backward(g, x, mask, w, b, gs, pad),
    }
    for kind, phases, count in (("pconv_k2", FWD_PHASES, 31), ("pconv_k2_bwd", BWD_PHASES, 30)):
        report(f"{kind} at the {name} ({cs.BATCH} x {h} x {h}, {cin} -> {cout})",
               cycles(lib, launch[kind]), phases, count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
