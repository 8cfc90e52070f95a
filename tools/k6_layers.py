#!/usr/bin/env python3
"""K6 (the depthwise weight gradient) layer by layer, on one NVIDIA GPU.

For each of the segmenter's five K6 shapes at 512^2 pages, batch 8, bf16
(``chip_smoke.py::SEG_SHAPES``): K6 against the f64 truth and twice on the
same inputs (bit-identical), then CUDA-event medians and torch.profiler
device time of

  - ``depthwise_wgrad`` as the Function's backward calls it (K6),
  - its plain version in f32,
  - cuDNN's bf16 wgrad of the same x and dy (``aten::convolution_backward``
    on channels-last views, never called for dW by the port),
  - the layer's dx two ways: the flipped-kernel conv, and cuDNN's dgrad,

beside the least time the card could take for K6 (x and dy read once),
each also summed over one seg train step's 14 launches. Then K6 against
the truth at ``chip_smoke.py::K6_RAGGED``. Runs in any tree whose
``depthwise_wgrad(x, dy, k, d)`` and ``chip_smoke.py`` have these names,
so an older tree can be timed beside this one in the same call:

    python3 tools/k6_layers.py [--hash]

``--hash`` only prints the SHA-256 of K6's dW bytes at the segmenter's
shapes (``SEG_SHAPES``), Xception's (``XCEPTION_SHAPES``) and
``K6_RAGGED``, on inputs drawn from a fixed seed: run it in two trees and
compare the lines to show that a change left the templated form's results
as they were.
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_layers: no CUDA device", file=sys.stderr)
        return 2
    from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip())
    cs.log(f"tree {ROOT}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.load_library()
    for line in build.last_build["log"].splitlines():
        if "dw_wgrad" in line or ("registers" in line and "dw" in line) or "spill" in line:
            cs.log(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda", 0)
    if "--hash" in sys.argv[1:]:
        return hash_dw(dev, kdw)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    bf = torch.bfloat16
    names = ("K6 events", "K6 device", "plain f32", "cuDNN wgrad", "dx flipped conv", "dx dgrad",
             "bound")
    tot = [0.0] * len(names)
    for name, h, c, d, count in cs.SEG_SHAPES:
        x = torch.randn((cs.BATCH, h, h, c), generator=gen, device=dev).to(bf)
        dy = torch.randn((cs.BATCH, h, h, c), generator=gen, device=dev).to(bf)
        res = cs.check_wgrad(f"K6 {name}", x, dy, 3, d)
        a, b = kdw.depthwise_wgrad(x, dy, 3, d), kdw.depthwise_wgrad(x, dy, 3, d)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"K6 {name}: two launches differ")
        w = (torch.randn((c, 1, 3, 3), generator=gen, device=dev) * 0.3).to(bf)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        kern = lambda: kdw.depthwise_wgrad(x, dy, 3, d)  # noqa: E731
        plain = lambda: kdw.depthwise_wgrad_reference(x, dy, 3, d)  # noqa: E731
        wgrad = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            dyn, xn, w, None, [1, 1], [d, d], [d, d], False, [0, 0], c, [False, True, False])
        flip = lambda: conv2d(dy, w.flip((2, 3)), padding=d, dilation=d, groups=c)  # noqa: E731
        dgrad = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            dyn, xn, w, None, [1, 1], [d, d], [d, d], False, [0, 0], c, [True, False, False])
        k1, k2 = cs.cuda_ms(kern), cs.cuda_ms(kern)
        t = [(k1 + k2) / 2, cs.device_ms(kern, "dw_wgrad"), cs.cuda_ms(plain), cs.cuda_ms(wgrad),
             cs.cuda_ms(flip), cs.cuda_ms(dgrad)]
        nbytes = 2.0 * x.numel() * x.element_size()
        t.append(cs.bound(2.0 * x.numel() * 9, nbytes)[0])
        cs.log(f"K6 {name} {tuple(x.shape)} d {d}, {count} per step: "
               + ", ".join(f"{nm} {v:.4f}" for nm, v in zip(names, t))
               + f" ms; {nbytes / t[1] / 1e6:.0f} GB/s of x and dy in device time; max |d| to "
               f"the f64 truth {res['K6']:.4g}; bit-identical over two launches")
        for i, v in enumerate(t):
            tot[i] += count * v
    cs.log("K6 over one seg step's 14 launches: "
           + ", ".join(f"{nm} {v:.4f}" for nm, v in zip(names, tot)) + " ms")
    for name, n, h, w, c, k, d, dt in cs.K6_RAGGED:
        x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
        dy = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
        res = cs.check_wgrad(f"K6 {name}", x, dy, k, d)
        cs.log(f"K6 {name}: max |d| to the f64 truth {res['K6']:.4g}")
    return 0


def hash_dw(dev, kdw) -> int:
    """SHA-256 of K6's dW bytes at every shape of the seg and Xception steps
    and at K6_RAGGED, each on inputs from its own seed."""
    cases = ([(f"seg {name}", cs.BATCH, h, h, c, 3, d, torch.bfloat16)
              for name, h, c, d, _ in cs.SEG_SHAPES]
             + [(f"xception {name}", cs.BATCH, h, h, c, 3, d, torch.bfloat16)
                for name, h, c, d, _ in cs.XCEPTION_SHAPES]
             + [(f"ragged {name}", *rest) for name, *rest in cs.K6_RAGGED])
    for i, (name, n, h, w, c, k, d, dt) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
        dy = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
        dw = kdw.depthwise_wgrad(x, dy, k, d).contiguous()
        digest = hashlib.sha256(dw.cpu().numpy().tobytes()).hexdigest()[:16]
        cs.log(f"hash K6 {name} {(n, h, w, c)} k {k} d {d} {dt}: {digest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
