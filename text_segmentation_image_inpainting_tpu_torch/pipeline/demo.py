"""Demo CLI: run the text-removal pipeline and save before/after images.

Counterpart of ``text_segmentation_image_inpainting_tpu/pipeline/demo.py``:

    python -m text_segmentation_image_inpainting_tpu_torch.pipeline.demo \\
        --out demo_out --pages 2 [--seg-ckpt seg.pt --unet-ckpt unet.pt] \\
        [--images dir/] [--device cuda|cpu]

The same flags, plus ``--device``: the first CUDA device (the default; a
host without CUDA is an error) or ``cpu``. Checkpoints are model
snapshots in either format ``models/base.py::load_model`` reads: the
port's (``--export`` of its CLIs) or the JAX package's. Without them the
models run with fresh random weights (flax's initialisers, from
``--seed``), which exercises the pipeline and shows the mask layout.
Pages are drawn and PNGs written with PIL, so the demo runs where PIL is
installed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from text_segmentation_image_inpainting_tpu_torch.data.text_overlay import segmentation_sample
from text_segmentation_image_inpainting_tpu_torch.models.base import load_model
from text_segmentation_image_inpainting_tpu_torch.pipeline.end_to_end import (
    TextRemovalPipeline,
    preprocess_page,
)
from text_segmentation_image_inpainting_tpu_torch.train.loop import add_device_flag, resolve_device


def save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    arr = np.clip(np.asarray(arr, dtype=np.float32), 0.0, 1.0)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", type=str, default="demo_out")
    p.add_argument("--pages", type=int, default=2)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seg-ckpt", type=str, default=None)
    p.add_argument("--unet-ckpt", type=str, default=None)
    p.add_argument("--images", type=str, default=None, help="input image dir; synthetic if unset")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--dilate", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    add_device_flag(p)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    size = (args.size, args.size)
    if args.images:
        from PIL import Image

        exts = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
        files = sorted(f for f in os.listdir(args.images) if f.lower().endswith(exts))[: args.pages]
        if not files:
            raise SystemExit(f"--images {args.images}: no image files found")
        args.pages = len(files)  # fewer images than --pages is fine
        loaded = [np.asarray(Image.open(os.path.join(args.images, f)).convert("RGB"), np.float32)
                  / 255.0 for f in files]
        pages = np.stack([preprocess_page(torch.from_numpy(im[None]), size)[0].numpy()
                          for im in loaded])
        gt_masks = None
    else:
        samples = [segmentation_sample(rng, size) for _ in range(args.pages)]
        pages = np.stack([s[0] for s in samples])
        gt_masks = np.stack([s[1] for s in samples])

    pipe = TextRemovalPipeline(threshold=args.threshold, dilate_radius=args.dilate)
    gen = torch.Generator().manual_seed(args.seed)
    pipe.seg.init_weights(gen)
    pipe.unet.init_weights(gen)
    if args.seg_ckpt:
        load_model(args.seg_ckpt, pipe.seg)
    if args.unet_ckpt:
        load_model(args.unet_ckpt, pipe.unet)
    pipe = pipe.to(device).eval()

    clean, masks = pipe.run(torch.from_numpy(pages).to(device))
    clean, masks = clean.float().cpu().numpy(), masks.float().cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    for i in range(args.pages):
        save_png(os.path.join(args.out, f"page{i}_before.png"), pages[i])
        save_png(os.path.join(args.out, f"page{i}_mask.png"), masks[i])
        save_png(os.path.join(args.out, f"page{i}_after.png"), clean[i])
        if gt_masks is not None:
            save_png(os.path.join(args.out, f"page{i}_gtmask.png"), gt_masks[i])
    print(f"wrote {args.pages} before/mask/after triplets to {args.out}/")


if __name__ == "__main__":
    main()
