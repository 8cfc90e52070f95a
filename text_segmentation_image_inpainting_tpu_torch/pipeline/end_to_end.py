"""Segment -> mask-dilate -> inpaint page pipeline.

Counterpart of ``text_segmentation_image_inpainting_tpu/pipeline/end_to_end.py``
with the U-Net in its literal composition: segmentation forward,
threshold in logit space, max-pool dilation, hole masking, partial-conv
inpainting (the decoder and head through kernels K1/K2 on CUDA) and the
final composite all stay on the device. Pages are (N, H, W, 3) in
[0, 1]; masks (N, H, W, 1).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.models.partial_convolution import InpaintUNet
from text_segmentation_image_inpainting_tpu_torch.models.text_segmentation import TextSegmenter
from text_segmentation_image_inpainting_tpu_torch.ops.morphology import dilate_mask
from text_segmentation_image_inpainting_tpu_torch.ops.resize import resize_bilinear
from text_segmentation_image_inpainting_tpu_torch.utils.profiling import span


def preprocess_page(image: torch.Tensor, size: Tuple[int, int] = (512, 512)) -> torch.Tensor:
    """Resize (N,H,W,3) uint8/float pages to float32 [0,1] at ``size``."""
    x = image.float()
    if image.dtype == torch.uint8:
        x = x / 255.0
    return resize_bilinear(x, size)


def pad_to_multiple(pages: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Edge-pad (N,H,W,C) bottom/right so H and W are multiples of ``multiple``.

    Returns (padded, (H, W)), the original size for cropping the output
    back. Edge padding keeps the pad region page-like (a constant fill
    would bleed into the partial convs at the border).
    """
    h, w = pages.shape[1], pages.shape[2]
    hp = -(-h // multiple) * multiple
    wp = -(-w // multiple) * multiple
    if (hp, wp) == (h, w):
        return pages, (h, w)
    padded = F.pad(pages.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h), mode="replicate")
    return padded.permute(0, 2, 3, 1).contiguous(), (h, w)


class TextRemovalPipeline(nn.Module):
    """Two-stage text removal, end to end on one device.

    Usage::

        pipe = TextRemovalPipeline().to("cuda").eval()
        clean, text_mask = pipe.run(pages)
    """

    def __init__(self, seg: TextSegmenter | None = None, unet: InpaintUNet | None = None, *,
                 threshold: float = 0.5, dilate_radius: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        # default models carry the compute dtype themselves, as in JAX
        self.seg = seg if seg is not None else TextSegmenter(dtype=compute_dtype)
        self.unet = unet if unet is not None else InpaintUNet(dtype=compute_dtype)
        self.threshold = threshold
        self.dilate_radius = dilate_radius
        self.compute_dtype = compute_dtype

    def _segment2d(self, pages: torch.Tensor, *, dilate: bool = True) -> torch.Tensor:
        """pages (N,H,W,3) -> dilated VALID mask (N,H,W), in compute_dtype.

        sigmoid(x) > t  <=>  x > logit(t); the comparison runs in the
        logits' dtype, with logit(t) rounded to it. The threshold is a fill
        on the device: ``torch.tensor(logit_t, device=...)`` would be a
        blocking host-to-device copy, a stream synchronize in every call.
        """
        with span("pipeline.segment"):
            logits = self.seg(pages.to(self.compute_dtype))
            logit_t = float(np.log(self.threshold / (1.0 - self.threshold)))
            thr = torch.full((), logit_t, dtype=logits.dtype, device=logits.device)
            text2d = (logits[..., 0] > thr).to(self.compute_dtype)
            if dilate:
                text2d = dilate_mask(text2d, self.dilate_radius)
            return 1.0 - text2d  # valid = not text

    @torch.no_grad()
    def segment(self, pages: torch.Tensor, *, dilate: bool = True) -> torch.Tensor:
        """pages (N,H,W,3) in [0,1] -> binary text mask (N,H,W,1).

        ``dilate=False`` skips the growth by ``dilate_radius`` (for scoring
        against an undilated ground-truth mask).
        """
        pages, (h, w) = pad_to_multiple(pages, 1 << self.unet.depth)
        return (1.0 - self._segment2d(pages, dilate=dilate))[:, :h, :w, None]

    @torch.no_grad()
    def inpaint(self, pages: torch.Tensor, text_mask: torch.Tensor) -> torch.Tensor:
        """Inpaint the text region; returns the composited clean page in
        compute_dtype. Arbitrary sizes are edge-padded to the U-Net
        multiple and cropped back."""
        pages, (h, w) = pad_to_multiple(pages, 1 << self.unet.depth)
        text_mask, _ = pad_to_multiple(text_mask, 1 << self.unet.depth)
        valid2d = 1.0 - text_mask[..., 0].to(self.compute_dtype)
        if (h, w) != tuple(pages.shape[1:3]):
            # the edge pad copied the text mask into the pad strip; the
            # strip is page margin, so force it valid
            keep = torch.zeros(pages.shape[1:3], dtype=valid2d.dtype, device=valid2d.device)
            keep[:h, :w] = 1.0
            valid2d = torch.maximum(valid2d, 1.0 - keep)
        return self._inpaint2d(pages, valid2d)[:, :h, :w]

    def _inpaint2d(self, pages: torch.Tensor, valid2d: torch.Tensor) -> torch.Tensor:
        with span("pipeline.inpaint"):
            pages = pages.to(self.compute_dtype)
            valid = valid2d[..., None]
            out = self.unet(pages * valid, valid)
            return valid * pages + (1.0 - valid) * out

    @torch.no_grad()
    def run(self, pages: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full pipeline: (clean_pages, text_mask) in compute_dtype."""
        pages, (h, w) = pad_to_multiple(pages, 1 << self.unet.depth)
        valid2d = self._segment2d(pages)
        clean = self._inpaint2d(pages, valid2d)
        return clean[:, :h, :w], (1.0 - valid2d)[:, :h, :w, None]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TextRemovalPipeline":
        """Random weights from ``generator`` (He-normal convs, small random
        biases) with random BatchNorm affine and running statistics, so
        every BatchNorm does real work. For runs without a checkpoint."""
        def rand(shape, scale=1.0, offset=0.0):
            return torch.randn(shape, generator=generator) * scale + offset

        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(rand(m.weight.shape, math.sqrt(2.0 / fan_in)))
                if m.bias is not None:
                    m.bias.copy_(rand(m.bias.shape, 0.1))
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(rand(m.weight.shape, 0.1, 1.0))
                m.bias.copy_(rand(m.bias.shape, 0.1))
                m.running_mean.copy_(rand(m.running_mean.shape, 0.1))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=generator) + 0.5)
        return self
