"""Resize ops with the JAX package's semantics on NHWC tensors.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/resize.py``:
bilinear with half-pixel centres and no antialias (torch
``align_corners=False``), and exact integer-factor nearest upsampling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.conv import to_nchw, to_nhwc


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (N, H, W, C) to (N, out_h, out_w, C), half-pixel centres."""
    oh, ow = out_hw
    if (oh, ow) == tuple(x.shape[1:3]):
        return x
    out = F.interpolate(
        to_nchw(x), size=(oh, ow), mode="bilinear", align_corners=False, antialias=False
    )
    return to_nhwc(out)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Exact integer-factor nearest upsampling of (N, H, W, C)."""
    if factor == 1:
        return x
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)
