"""The evaluation CLI: the parity-gate metrics.

    python -m text_segmentation_image_inpainting_tpu_torch.train.evaluate \\
        --task seg|inpaint|pipeline --batches 8 [--seg-ckpt ... --unet-ckpt ...]

Counterpart of ``text_segmentation_image_inpainting_tpu/train/evaluate.py``,
with its flags and JSON keys plus ``--device cuda|cpu`` (default
``cuda``; a host without CUDA is an error). ``--task seg`` scores the
IoU, precision and recall of ``segment(dilate=False)``; ``--task
inpaint`` the PSNR, SSIM and L1 of ``inpaint`` against the clean page;
``--task pipeline`` the ``mask_iou`` of ``segment(dilate=False)`` on seg
pages (they carry no clean page), as JAX scores it. Checkpoints load
through ``models/base.py::load_model``, so JAX snapshots load too;
without one a model keeps flax's initialisers drawn from a generator
seeded with 0. Pages come from ``make_dataset`` in index order (JAX's
through grain's shuffle: the same pages per index, not per batch). Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from text_segmentation_image_inpainting_tpu_torch.data.pipeline import (
    list_image_paths,
    make_dataset,
    to_device,
)
from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, TextSegmenter
from text_segmentation_image_inpainting_tpu_torch.models.base import load_model
from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline
from text_segmentation_image_inpainting_tpu_torch.train.loop import add_device_flag, resolve_device
from text_segmentation_image_inpainting_tpu_torch.train.metrics import iou, psnr, ssim


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", choices=["seg", "inpaint", "pipeline"], default="pipeline")
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seg-ckpt", type=str, default=None)
    p.add_argument("--unet-ckpt", type=str, default=None)
    # model geometry: must match the trained checkpoints
    p.add_argument("--width-mult", type=float, default=1.0)
    p.add_argument("--backbone", choices=("mobilenet_v2", "xception"), default="mobilenet_v2")
    p.add_argument("--head", choices=("mini", "deeplab"), default="mini")
    p.add_argument("--output-stride", type=int, default=8, choices=(8, 16, 32))
    p.add_argument("--decoder-mid", type=int, default=128)
    p.add_argument("--depth", type=int, default=8, help="inpaint U-Net depth")
    p.add_argument("--attention", action="store_true")
    p.add_argument("--attention-sn", action="store_true")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=1234)
    add_device_flag(p)
    return p.parse_args(argv)


def build_pipeline(args) -> TextRemovalPipeline:
    """The bf16 pipeline of ``args``' geometry, checkpoints loaded."""
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    seg = TextSegmenter(width_mult=args.width_mult, output_stride=args.output_stride,
                        decoder_mid=args.decoder_mid, backbone=args.backbone, head=args.head,
                        dtype=bf).init_weights(gen)
    unet = InpaintUNet(depth=args.depth, attention=args.attention or args.attention_sn,
                       attention_sn=args.attention_sn, dtype=bf).init_weights(gen)
    if args.seg_ckpt:
        load_model(args.seg_ckpt, seg)
    if args.unet_ckpt:
        load_model(args.unet_ckpt, unet)
    return TextRemovalPipeline(seg, unet)


def eval_seg(pipe, batch):
    # the raw thresholded mask: the dilation (for the inpainting hand-off)
    # would deflate IoU and precision
    mask = pipe.segment(batch["image"], dilate=False).float()
    gt = batch["mask"]
    tp = (mask * gt).sum()
    return {"iou": iou(mask, gt),
            "precision": tp / torch.clamp(mask.sum(), min=1e-6),
            "recall": tp / torch.clamp(gt.sum(), min=1e-6)}


def eval_inpaint(pipe, batch):
    gt = batch["image"]
    comp = pipe.inpaint(gt, 1.0 - batch["mask"]).float()
    return {"psnr": psnr(comp, gt), "ssim": ssim(comp, gt), "l1": (comp - gt).abs().mean()}


def eval_pipeline(pipe, batch):
    # one segmenter forward, undilated: the dilated hand-off mask is scored nowhere
    raw = pipe.segment(batch["image"], dilate=False)
    return {"mask_iou": iou(raw.float(), batch["mask"])}


TASKS = {"seg": eval_seg, "inpaint": eval_inpaint, "pipeline": eval_pipeline}


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    pipe = build_pipeline(args).to(device).eval()
    size = (args.size, args.size)
    kind = "inpaint" if args.task == "inpaint" else "seg"
    paths = list_image_paths(args.data_dir) if args.data_dir else None
    it = make_dataset(kind, batch_size=args.batch_size, size=size, seed=args.seed, paths=paths)
    fn = TASKS[args.task]
    acc: dict = {}
    for _ in range(args.batches):
        for k, v in fn(pipe, to_device(next(it), device)).items():
            acc.setdefault(k, []).append(float(v))
    result = {k: float(np.mean(v)) for k, v in acc.items()}
    result.update(task=args.task, batches=args.batches, batch_size=args.batch_size)
    print(json.dumps(result))
    return result


def cli(argv=None) -> None:
    """Console-script entry: ``main``'s dict would read as exit status 1."""
    main(argv)


if __name__ == "__main__":
    main()
