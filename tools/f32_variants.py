#!/usr/bin/env python3
"""What K4F's conv1 passes pay for staging their operands, on one NVIDIA GPU.

``stem_f32_conv1`` (``csrc/vgg_stem.cu``) stages each 8-channel chunk's
input window and its weights (18.4 KB) into a ring of shared stages for
every tile. Keeping conv1's 147 KB of f32 weights resident instead leaves
no room for a second CTA on an SM; this script measures what the
restaging costs, so the choice rests on a number. It builds copies of the
kernel source in which every CTA copies the weights (or the window) only
while it fills its ring for its first tile, and keeps whatever the ring
holds after that: the results are wrong, the times are those of a kernel
that does not restage. It prints K4F at x (16, 512, 512, 3) and K5F at z0
(8, 512, 512, 64), CUDA events and each pass's device time
(torch.profiler), for the source as it is and for each copy, in turns,
with the SM clock and power that nvidia-smi reads while K4F runs.

    python3 tools/f32_variants.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
from phase_clocks import CSRC, PRELUDE, build_copy, card, patch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build  # noqa: E402
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs  # noqa: E402

FIRST_FILL = "tile != (int)blockIdx.x || c0 >= SF_STAGES * SF_CK"
WEIGHTS = "  for (int i = tid; i < 9 * SF_CK * C / 4; i += SF_THREADS)\n"
WINDOW = "  if (MODE == SF_POOL) {  // z0, NHWC: 4-byte copies, channel-major as they land\n"
VARIANTS = {
    "weights staged once a CTA": (WEIGHTS, f"  if ({FIRST_FILL}) return;\n" + WEIGHTS),
    "window staged once a CTA": (WINDOW, f"  if ({FIRST_FILL}) {{\n  }} else " + WINDOW.lstrip()),
}


build_library = build.build_library


def use(lib_path: Path | None) -> None:
    """Load the kernels from ``lib_path`` (None: the package's own build)."""
    build._lib = None
    if lib_path is None:
        build.build_library = build_library
    else:
        build.build_library = lambda: lib_path
    build.load_library()


def measure(label: str, xs, gs, z0, w0, b0, w1, b1) -> None:
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    k4 = cs.cuda_ms(lambda: kvs.stem_dx(xs, gs, w0, b0, w1, b1), iters=10, warmup=2)
    smi.terminate()
    samples = [line.split(",") for line in smi.communicate()[0].splitlines() if "," in line]
    clocks = sorted(float(c) for c, _ in samples)
    watts = sorted(float(w) for _, w in samples)
    k5 = cs.cuda_ms(lambda: kvs.stem_pool(z0, w1, b1), iters=10, warmup=2)
    passes = cs.kernel_ms(lambda: kvs.stem_dx(xs, gs, w0, b0, w1, b1))
    if clocks:
        print(f"{label}: SM clock while K4F ran (nvidia-smi, {len(clocks)} samples): median "
              f"{clocks[len(clocks) // 2]:.0f} MHz, min {clocks[0]:.0f}; power median "
              f"{watts[len(watts) // 2]:.0f} W")
    print(f"{label}: K4F {k4:.3f} ms, K5F {k5:.3f} ms; device ms per pass: "
          + ", ".join(f"{k} {v:.3f}" for k, v in passes.items() if k.startswith("stem_f32")),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("f32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    print(card())
    src = (CSRC / "vgg_stem.cu").read_text()
    others = [CSRC / "partial_conv.cu", CSRC / "depthwise_wgrad.cu"]
    # PRELUDE: the g_clk that build_copy's reader needs (no marks are set)
    libs = {name: build_copy(f"f32_variant_{i}", PRELUDE + patch(src, *edit), others)
            for i, (name, edit) in enumerate(VARIANTS.items())}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    w0, b0, w1, b1 = cs.stem_weights(gen, dev)
    xs = torch.randn((16, 512, 512, 3), generator=gen, device=dev)
    gs = torch.randn((16, 256, 256, 64), generator=gen, device=dev)
    z0 = torch.randn((8, 512, 512, 64), generator=gen, device=dev)
    order = [None, *libs, None, *reversed(list(libs))]
    for name in order:
        use(None if name is None else libs[name])
        measure("as committed" if name is None else name, xs, gs, z0, w0, b0, w1, b1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
