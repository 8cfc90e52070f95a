#!/usr/bin/env python3
"""Where the VGG stem kernels' time goes, phase by phase, on one NVIDIA GPU.

The card's machine runs no ncu or nsys, so this script builds a copy of
``csrc/vgg_stem.cu`` with ``clock64()`` read at the end of each phase of
the consumers (and of K5's producer) by one thread of every CTA, summed
over the CTAs with atomics, and prints the cycles per tile of each phase
for K4 at (16, 512, 512) and K5 at (8, 512, 512), the train step's
shapes, with the clock rate (cycles over ``%globaltimer`` ns). The phases
are marked after the consumers' named barriers and waits, so a phase
includes the wait for the slowest warp. The atomics cost a few percent;
time the kernels with ``chip_smoke.py``, not with this.

    python3 tools/stem_phase_clocks.py
"""

from __future__ import annotations

import ctypes
import sys

import torch
from phase_clocks import CSRC, PRELUDE, START, build_copy, card, cycles, marked, patch, report

K4_PHASES = {0: "wait for x", 10: "im2col", 11: "conv0 (wgmma) + epilogue",
             1: "conv1 forward (wgmma)", 3: "z1 epilogue", 12: "wait for g",
             13: "pool gradient", 2: "conv1 dgrad (wgmma)", 14: "gz0 epilogue",
             15: "Q = W0^T gz0 (wgmma)", 16: "dx tap gather"}
K5_PHASES = {24: "issue next products", 20: "wait for input", 21: "wait for products",
             22: "z1 epilogue", 23: "pool", 26: "producer: issue loads",
             25: "producer: wait for a free buffer", 27: "producer: relu + store"}


def instrumented() -> str:
    src = (CSRC / "vgg_stem.cu").read_text()
    src = patch(src, "namespace {\n\nusing bf16", PRELUDE + "namespace {\n\nusing bf16")
    a = src.index("__device__ __forceinline__ void stem_dx_consumers(")
    b = src.index("__global__ void __launch_bounds__(THREADS, 1) stem_dx_kernel")
    k4 = patch(src[a:b], 'setmaxnreg.inc.sync.aligned.u32 216;\\n");',
               'setmaxnreg.inc.sync.aligned.u32 216;\\n");' + START)
    k4 = marked(k4, "named_sync(1, CONSUMERS);", 10)
    k4 = patch(k4, "mbar_wait(&sm.bar[0], i & 1);", "mbar_wait(&sm.bar[0], i & 1); CLK(0);")
    k4 = patch(k4, "mbar_wait(&sm.bar[2], i & 1);", "mbar_wait(&sm.bar[2], i & 1); CLK(3);")
    k4 = patch(k4, "conv1_wgmma<false>(acc, w1a, a0a, DX_P, wg * DX_Z1_N);",
               "conv1_wgmma<false>(acc, w1a, a0a, DX_P, wg * DX_Z1_N); CLK(1);")
    k4 = patch(k4, "conv1_wgmma<true>(acc, w1a, z1a, DX_P, wg * DX_GZ0_N);",
               "conv1_wgmma<true>(acc, w1a, z1a, DX_P, wg * DX_GZ0_N); CLK(2);")
    k4 = patch(k4, "    const Tile tl = tile_at(tile, p.h, p.w, DX_TH, DX_TW);\n",
               "    const Tile tl = tile_at(tile, p.h, p.w, DX_TH, DX_TW);"
               " if (threadIdx.x == 0) atomicAdd(&g_clk[31], 1ull);\n")
    src = src[:a] + k4 + src[b:]
    a = src.index("__device__ __forceinline__ void stem_pool_consumers(")
    b = src.index("StemParams make_params(")
    k5 = patch(src[a:b], 'setmaxnreg.inc.sync.aligned.u32 200;\\n");',
               'setmaxnreg.inc.sync.aligned.u32 200;\\n");' + START +
               " const long long c0_ = clk_last; unsigned long long t0_;"
               ' asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0_));')
    k5 = patch(k5, "mbar_wait(&full_bar[i % PL_STAGES], (i / PL_STAGES) & 1);",
               "CLK(24); mbar_wait(&full_bar[i % PL_STAGES], (i / PL_STAGES) & 1); CLK(20);")
    k5 = patch(k5, "fence_acc(acc0);", "CLK(21); fence_acc(acc0);")
    k5 = patch(k5, "fence_acc(acc1);", "CLK(21); fence_acc(acc1);")
    k5 = patch(k5, "named_sync(1 + wg, 128);", "named_sync(1 + wg, 128); CLK(22);")
    k5 = patch(k5, "    mbar_arrive(&empty_bar[i % PL_STAGES]);",
               "    CLK(23); if (threadIdx.x == 0) atomicAdd(&g_clk[30], 1ull);"
               " mbar_arrive(&empty_bar[i % PL_STAGES]);")
    k5 = patch(k5, "    finish(acc1, i + 1);\n  }\n}",
               "    finish(acc1, i + 1);\n  }\n  if (threadIdx.x == 0) {"
               ' unsigned long long t1_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1_));'
               " atomicAdd(&g_clk[28], (unsigned long long)(clock64() - c0_));"
               " atomicAdd(&g_clk[29], t1_ - t0_); }\n}")
    k5 = patch(k5, "const int t = tid - CONSUMERS, c = t & 7;",
               "const int t = tid - CONSUMERS, c = t & 7;" + START)
    k5 = patch(k5, "if (k == 0 && i >= PL_STAGES) mbar_wait(&empty_bar[b], (i / PL_STAGES + 1) & 1);",
               "if (k == 0) { CLKP(26); } if (k == 0 && i >= PL_STAGES)"
               " mbar_wait(&empty_bar[b], (i / PL_STAGES + 1) & 1); if (k == 0) { CLKP(25); }")
    k5 = patch(k5, "      mbar_arrive(&full_bar[b]);\n", "      mbar_arrive(&full_bar[b]); CLKP(27);\n")
    return src[:a] + k5 + src[b:]


def main() -> int:
    if not torch.cuda.is_available():
        print("stem_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs

    lib = ctypes.CDLL(str(build_copy("phase_clocks", instrumented())))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tsii_stem_dx.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.tsii_stem_pool.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]

    dev, bf = torch.device("cuda"), torch.bfloat16
    print(card())
    gen = torch.Generator(dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    w0, b0, w1, b1 = rnd(64, 3, 3, 3) * 0.3, rnd(64) * 0.1, rnd(64, 64, 3, 3) * 0.06, rnd(64) * 0.1
    w0t = w0.to(bf).permute(0, 2, 3, 1).reshape(64, 27).contiguous()
    w1t, b0f, b1f = kvs._w1_taps(w1), kvs._bias(b0), kvs._bias(b1)
    x, g = rnd(16, 512, 512, 3).to(bf), rnd(16, 256, 256, 64).to(bf)
    z0 = rnd(8, 512, 512, 64).to(bf)
    dx = torch.empty((16, 512, 512, 3), device=dev)
    pooled = torch.empty((8, 256, 256, 64), device=dev, dtype=bf)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    launch = {
        "K4": lambda: lib.tsii_stem_dx(x.data_ptr(), g.data_ptr(), w0t.data_ptr(), b0f.data_ptr(),
                                       w1t.data_ptr(), b1f.data_ptr(), dx.data_ptr(), 16, 512,
                                       512, kvs.stem_grid(16, 512, 512, sms), stream),
        "K5": lambda: lib.tsii_stem_pool(z0.data_ptr(), w1t.data_ptr(), b1f.data_ptr(),
                                         pooled.data_ptr(), 8, 512, 512,
                                         kvs.stem_grid(8, 512, 512, sms), stream),
    }

    def checked(kind):
        if launch[kind]() != 0:
            raise RuntimeError(f"{kind} launch failed")

    for kind, phases, count in (("K4", K4_PHASES, 31), ("K5", K5_PHASES, 30)):
        v = cycles(lib, lambda: checked(kind))
        report(kind, v, phases, count, total="sum over the consumers", skip=(25, 26, 27))
        if kind == "K5":
            print(f"  clock: {v[28] / max(v[29], 1):.3f} GHz (cycles over globaltimer ns)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
