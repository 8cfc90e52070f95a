"""On-device binary mask morphology.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/morphology.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    """
    if radius <= 0 or iterations <= 0:
        return mask
    k = 2 * radius + 1
    squeezed = mask.dim() == 3
    out = mask[..., None] if squeezed else mask
    out = out.permute(0, 3, 1, 2)  # (N, C, H, W)
    for _ in range(iterations):
        out = F.max_pool2d(out, (k, 1), stride=1, padding=(radius, 0))
        out = F.max_pool2d(out, (1, k), stride=1, padding=(0, radius))
    out = out.permute(0, 2, 3, 1)
    return out[..., 0] if squeezed else out.contiguous()
