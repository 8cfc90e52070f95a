"""On-device binary mask morphology.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/morphology.py``.
Under ``ops.bands.spatial_axis`` ``dilate_mask`` runs on one H band.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.bands import active_spatial_axis


def binarize(prob: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Probability map -> {0,1} mask (same dtype)."""
    return (prob > threshold).to(prob.dtype)


def dilate_mask(mask: torch.Tensor, radius: int = 3, iterations: int = 1) -> torch.Tensor:
    """Binary dilation with a (2r+1)x(2r+1) square structuring element.

    ``mask`` is (N, H, W, C) or squeezed (N, H, W), values in {0, 1}. The
    square max separates into a vertical and a horizontal pass. The JAX
    window pads with 0 where ``max_pool2d`` pads with -inf; for masks in
    {0, 1} the two give the same maximum, since every window holds at
    least one in-image pixel.

    Under ``spatial_axis`` the mask is one H band: each vertical pass
    first takes ``radius`` rows from the bands on either side (zeros past
    the page, which for such masks is the padding again) and pools with H
    padding 0.
    """
    if radius <= 0 or iterations <= 0:
        return mask
    k = 2 * radius + 1
    squeezed = mask.dim() == 3
    out = mask[..., None] if squeezed else mask
    ring = active_spatial_axis()
    pad_h = radius if ring is None else 0
    for _ in range(iterations):
        if ring is not None:
            out = ring.exchange_rows(out, radius, radius)
        o = out.permute(0, 3, 1, 2)  # (N, C, H, W)
        o = F.max_pool2d(o, (k, 1), stride=1, padding=(pad_h, 0))
        o = F.max_pool2d(o, (1, k), stride=1, padding=(0, radius))
        out = o.permute(0, 2, 3, 1)
    return out[..., 0] if squeezed else out.contiguous()


def erode_mask(mask: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Binary erosion (a (2r+1)x(2r+1) min-pool) of (N, H, W, C), the dual
    of :func:`dilate_mask`. Like the JAX window, the border counts as 1."""
    if radius <= 0:
        return mask
    k = 2 * radius + 1
    padded = F.pad(mask.permute(0, 3, 1, 2), (radius,) * 4, value=1.0)
    return (-F.max_pool2d(-padded, k, stride=1)).permute(0, 2, 3, 1).contiguous()
