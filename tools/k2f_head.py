#!/usr/bin/env python3
"""K2F and its backward at the U-Net's head, on one NVIDIA GPU.

At the head's shape (x (8, 512, 512, 67) f32, mask groups (64, 3), 3
outputs, k 3, padding 1; ``chip_smoke.py``'s inputs for its last layer),
CUDA-event medians and each device kernel's time (torch.profiler) of

  - K2F, ``partial_conv2d_fused`` on an f32 x,
  - its backward, ``partial_conv2d_backward`` (``pconv_k3_prep``, then the
    head's kernels and ``pconv_colsum``), and the same asked for dx only
    and for dW only,
  - cuDNN's f32 conv on x already masked and its ``convolution_backward``,
    TF32 off (yardsticks the port never calls),

with the card's name and power limit. It uses only the package's public
functions, so it also times an older tree's head kernels when copied into
that tree and run there. With ``--copy4`` it also builds a copy of the
kernel source whose ``k2f_fill`` copies x in 4-byte ``cp.async`` words
(into the same layout) instead of 16-byte words, checks that both give the
same bits, and times them in turns: as committed, the copy, the copy, as
committed. With ``--probes`` it builds copies that each leave out one
part of a kernel's work (``PROBES``: their results are wrong, their times
say what that part costs) and times each after the source as committed.

    python3 tools/k2f_head.py [--copy4] [--probes]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import threading
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build  # noqa: E402
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import (  # noqa: E402
    partial_conv as kpc,
)
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import apply_mask  # noqa: E402

COPY16 = """    for (long long q = q0 + 4ll * tid; q < q1; q += 4ll * nth) {
      const long long left = x_floats - q;
      cp_async16(smem_u32(stage + (q - al)), x + q, left >= 4 ? 16 : (int)left * 4);
    }"""
COPY4 = """    for (long long q = (rp + a) * cin + tid; q < (rp + e) * cin; q += nth)
      cp_async4(smem_u32(stage + (q - al)), x + q, 4);"""
# Copies that each leave out one part of the work: (anchor, replacement) pairs
_W = "reinterpret_cast<const float4*>(ws + c * WPC)[v]"
_X = "xv[i] = masked(xb[i * cin + c], mv[i]);"
_MSUM = "            c0 += mr[2 * dx];\n            if (p.g == 2) c1 += mr[2 * dx + 1];"
PROBES = {
    "K2F, weights read once a row": [(_W, _W.replace("c * WPC", "ca * WPC"))],
    "K2F, x read once a row": [(_X, _X.replace("+ c]", "+ ca]"))],
    "K2F, no window count": [(_MSUM, "            c0 += 1.f;")],
    "backward, no dx stores": [("dxp[(size_t)j * cin] = masked(t, m);",
                                "if (t == 12345.f) dxp[(size_t)j * cin] = t;")],
    "backward, no x reads": [("const float xm = masked(xr[j * cin], m);",
                              "const float xm = m * (float)j;")],
    "backward, no window reads": [
        ("load_cout<COUT>(d[dy][0], dr[dy] + (j + K - 1) * CP);",
         "load_cout<COUT>(d[dy][0], dr[dy] + (sa + K - 1) * CP);")],
    "backward, no x copies": [("rowf, p.need_dw != 0, tid, nth);", "rowf, false, tid, nth);")],
}


def device_kernels(fn, windows: int = 3, calls: int = 2) -> dict:
    """{kernel: (ms a launch, launches a call)} over ``windows`` profiled
    windows of ``calls`` calls each (medians; the profiler now and then
    drops a launch)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0:
                name = e.key.split("::", 1)[-1].split("(")[0]
                seen.setdefault(name, []).append((e.self_device_time_total / 1e3 / e.count,
                                                  e.count / calls))
    return {k: (statistics.median(a for a, _ in v), max(c for _, c in v)) for k, v in seen.items()}


def head_inputs(dev):
    rng = np.random.default_rng(cs.SEED)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    _, h, c_lo, c_skip, cout = cs.SHAPES[-1]
    cin = c_lo + c_skip
    x = torch.randn((cs.BATCH, h, h, cin), generator=gen, device=dev)
    m = cs.grouped_mask(rng, cs.BATCH, h, h, dev).float()
    w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    g = torch.randn((cs.BATCH, h, h, cout), generator=gen, device=dev)
    return x, m, w, b, g, (c_lo, c_skip)


def calls(x, m, w, b, g, gs) -> dict:
    pad = (1, 1)
    return {
        "K2F": lambda: kpc.partial_conv2d_fused(x, m, w, b, group_sizes=gs, padding=pad),
        "K3F head": lambda: kpc.partial_conv2d_backward(g, x, m, w, b, gs, pad),
        "K3F head, dx only": lambda: kpc.partial_conv2d_backward(g, x, m, w, b, gs, pad,
                                                                 (True, False, False)),
        "K3F head, dW only": lambda: kpc.partial_conv2d_backward(g, x, m, w, b, gs, pad,
                                                                 (False, True, False)),
    }


def measure(label: str, fns: dict, smi: str) -> dict:
    out = {}
    for what, fn in fns.items():
        ms = cs.cuda_ms(fn)
        ks = device_kernels(fn)
        dev_ms = sum(t * n for t, n in ks.values())
        out[what] = ms
        print(f"{label}: {what} {ms:.4f} ms (CUDA events), device {dev_ms:.4f} ms a call: "
              + ", ".join(f"{k} {t:.4f} x{n:g}" for k, (t, n) in sorted(ks.items()))
              + f"  [{smi}]", flush=True)
    return out


def use(lib_path: Path | None) -> None:
    """Load the kernels from ``lib_path`` (None: the package's own build)."""
    build._lib = None
    build.build_library = (lambda: lib_path) if lib_path else BUILD_LIBRARY
    build.load_library()


BUILD_LIBRARY = build.build_library


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--copy4", action="store_true",
                    help="also time a copy whose k2f_fill copies x in 4-byte words")
    ap.add_argument("--probes", action="store_true",
                    help="also time copies that each leave out one part of the work")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2f_head: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from phase_clocks import CSRC, PRELUDE, build_copy, card, patch

    smi = card()
    print(smi)
    build.load_library()
    print(f"build: nvcc {build.last_build['seconds']:.1f} s")
    for line in getattr(cs, "ptxas_report", lambda _: [])(("pconv_k2f", "pconv_f32")):
        print(f"  ptxas: {line}")
    x, m, w, b, g, gs = head_inputs(dev)
    fns = calls(x, m, w, b, g, gs)
    xm = apply_mask(x, m, gs).permute(0, 3, 1, 2)
    wcl = w.contiguous(memory_format=torch.channels_last)
    gcl = g.permute(0, 3, 1, 2)
    lib = {"cuDNN f32 conv": lambda: torch.nn.functional.conv2d(xm, wcl, padding=1),
           "cuDNN f32 convolution_backward": lambda: torch.ops.aten.convolution_backward(
               gcl, xm, wcl, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
               [True, True, False])}
    measure("as committed", fns, smi)
    measure("library", lib, smi)
    src = (CSRC / "partial_conv.cu").read_text()
    others = [CSRC / "vgg_stem.cu", CSRC / "depthwise_wgrad.cu"]
    edits = dict(PROBES) if args.probes else {}
    if args.copy4:
        edits["4-byte copies"] = [(COPY16, COPY4)]
    libs = {}

    def make(i, name):
        patched = src
        for old, new in edits[name]:
            patched = patch(patched, old, new)
        libs[name] = build_copy(f"k2f_variant_{i}", PRELUDE + patched, others)

    threads = [threading.Thread(target=make, args=(i, n)) for i, n in enumerate(edits)]
    for t in threads:  # one nvcc each, all at once
        t.start()
    for t in threads:
        t.join()
    if len(libs) != len(edits):
        raise SystemExit(f"built {sorted(libs)} of {sorted(edits)}")
    for name in PROBES if args.probes else ():
        part = {k: f for k, f in fns.items() if k.startswith("K2F") == name.startswith("K2F")}
        use(libs[name])
        measure(name, part, smi)
        use(None)
        measure("as committed", part, smi)
    if args.copy4:
        copy = libs["4-byte copies"]
        want = [t.clone() for t in fns["K2F"]()] + list(fns["K3F head"]())
        use(copy)
        got = list(fns["K2F"]()) + list(fns["K3F head"]())
        same = all(torch.equal(a, c) for a, c in zip(want, got))
        print(f"4-byte copies: K2F and its backward bit-equal to the 16-byte copies: {same}")
        for label, path in (("4-byte copies", copy),) * 2 + (("as committed", None),):
            use(path)
            measure(label, fns, smi)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
