"""The system under test, built from a configuration file: the port's own
classes and entry points, nothing else of it. Its weights are the
benchmark's (``weights.py``), loaded by name with every key checked, so
a configuration file that disagreed with the port's layer tables would
fail here rather than measure another model."""

from __future__ import annotations

import torch


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["compute_dtype"])


def segmenter(cfg: dict):
    from text_segmentation_image_inpainting_tpu_torch.models import TextSegmenter

    s = cfg["segmenter"]
    return TextSegmenter(width_mult=s["width_mult"], output_stride=s["output_stride"],
                         decoder_mid=s["decoder_mid"], backbone=s["backbone"], head=s["head"],
                         middle_repeats=s.get("middle_repeats", 8), dtype=dtype_of(cfg))


def unet(cfg: dict):
    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet

    return InpaintUNet(depth=cfg["inpainter"]["depth"], dtype=dtype_of(cfg))


def pipeline(cfg: dict):
    from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline

    p = cfg["pipeline"]
    return TextRemovalPipeline(segmenter(cfg), unet(cfg), threshold=p["threshold"],
                               dilate_radius=p["dilate_radius"], compute_dtype=dtype_of(cfg))


def loss_config(cfg: dict, traffic: dict):
    from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import InpaintLossConfig

    w = cfg["loss"]
    return InpaintLossConfig(valid=w["valid"], hole=w["hole"], perceptual=w["perceptual"],
                             style=w["style"], tv=w["tv"], vgg_taps=w["vgg_taps"],
                             vgg_dtype=traffic["vgg_dtype"], fused_stem=traffic["fused_stem"])


def optimizer_config(cfg: dict):
    from text_segmentation_image_inpainting_tpu_torch.train.config import OptimizerConfig

    o = cfg["optimizer"]
    return OptimizerConfig(kind="adam", learning_rate=o["learning_rate"], beta1=o["beta1"],
                           beta2=o["beta2"])


def load(module, state: dict) -> None:
    module.load_state_dict(state, strict=True)
