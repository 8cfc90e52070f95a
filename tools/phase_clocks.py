"""What ``stem_phase_clocks.py`` and ``k2_phase_clocks.py`` share.

The card's machine runs no ncu or nsys, so each of those scripts builds a
copy of one kernel source with ``clock64()`` read by one thread of every
CTA at the end of each phase and summed over the CTAs with atomics into
``g_clk[32]``. Here are the marker macros, the text patching that refuses
a stale anchor, the build of the copy under the package's ``_build/`` and
the read-out; the scripts hold their kernel's anchors and phase labels.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "text_segmentation_image_inpainting_tpu_torch" / "csrc"
sys.path.insert(0, str(ROOT))

# CLK(k) adds thread 0's cycles since its last mark to g_clk[k]; CLKP(k)
# does so for thread 256, the first of the stem kernels' producers
PRELUDE = """__device__ unsigned long long g_clk[32];
#define CLKT(k, th) if (threadIdx.x == th) { const long long now_ = clock64(); \\
  atomicAdd(&g_clk[k], (unsigned long long)(now_ - clk_last)); clk_last = now_; }
#define CLK(k) CLKT(k, 0)
#define CLKP(k) CLKT(k, 256)
"""
START = " long long clk_last = clock64();"
# reads the sums and sets them to zero
READER = """
extern "C" int tsii_clk(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  unsigned long long z[32] = {};
  return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
}
"""


def patch(src: str, old: str, new: str, count: int = 1) -> str:
    """Replace ``old`` exactly ``count`` times; a missing anchor is an error,
    so a changed kernel cannot be measured with stale markers."""
    if src.count(old) != count:
        raise SystemExit(f"anchor found {src.count(old)} times, want {count}: {old!r}")
    return src.replace(old, new)


def marked(body: str, sync: str, first: int) -> str:
    """CLK(first + n) after the n-th ``sync`` of ``body``."""
    parts = body.split(sync)
    return "".join(p + (f"{sync} CLK({first + n});" if n < len(parts) - 1 else "")
                   for n, p in enumerate(parts))


def build_copy(name: str, source: str, others=()) -> Path:
    """Write ``source + READER`` to ``_build/<name>/``, compile it with the
    package's flags (and ``others``, further .cu files) into a shared
    library there, and return the library's path."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build

    out = CSRC.parent / "_build" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "clk.cu").write_text(source + READER)
    (out / "sm90.cuh").write_bytes((CSRC / "sm90.cuh").read_bytes())
    lib_path = out / "libclk.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(out / "clk.cu"), *map(str, others)], check=True, capture_output=True)
    return lib_path


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def cycles(lib, launch) -> list:
    """g_clk after the second of two ``launch()`` (the first warms up)."""
    lib.tsii_clk.argtypes = [ctypes.c_void_p]
    clk = (ctypes.c_ulonglong * 32)()
    for _ in range(2):
        lib.tsii_clk(clk)
        launch()
        torch.cuda.synchronize()
    lib.tsii_clk(clk)
    return list(clk)


def report(title: str, v: list, phases: dict, count: int, total: str = "sum",
           skip: tuple = ()) -> None:
    """Print the cycles per tile of each phase; ``v[count]`` holds the tiles,
    and the phases in ``skip`` stay out of the total."""
    tiles = max(v[count], 1)
    width = max(map(len, [*phases.values(), total]))
    print(f"{title}: cycles per tile on thread 0 of each CTA ({v[count]} tiles)")
    for k, label in phases.items():
        print(f"  {label:{width}s} {v[k] / tiles:8.0f}")
    print(f"  {total:{width}s} {sum(v[k] for k in phases if k not in skip) / tiles:8.0f}")
