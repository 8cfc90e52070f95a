#!/usr/bin/env python3
"""Hash K1's and K2's outputs at the U-Net's 8 stride-1 layers, on the card.

The inputs are ``chip_smoke.py``'s parity cases (``SHAPES`` at 512^2,
batch 8, padding (1, 1), the same generator seeds), so two source trees
give the same inputs. Run it in each tree, in one call, and compare the
hashes: equal hashes mean the kernels' bytes (y and M') are identical.

    python3 tools/pconv_bits.py [--out FILE]

Prints one line per layer and, last, a JSON object {layer: sha256 of
y's and M''s bytes}; ``--out`` also writes that object to FILE.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pconv_bits: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import BATCH, SEED, SHAPES, grouped_mask
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hashes = {}
    for name, h, c_lo, c_skip, cout in SHAPES:
        cin = c_lo + c_skip
        x = torch.randn((BATCH, h, h, cin), generator=gen, device=dev).to(torch.bfloat16)
        mask = grouped_mask(rng, BATCH, h, h, dev)
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1 if cout <= 7 else None
        y, m = kpc.partial_conv2d_fused(x, mask, w, b, group_sizes=(c_lo, c_skip), padding=(1, 1))
        digest = hashlib.sha256()
        for t in (y, m):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        hashes[name] = digest.hexdigest()
        print(f"{name}: y {tuple(y.shape)} {hashes[name]}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(hashes, indent=1))
    print(json.dumps(hashes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
