"""Resize ops with the JAX package's semantics on NHWC tensors.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/resize.py``:
bilinear with half-pixel centres and no antialias (torch
``align_corners=False``) or with aligned corners, and exact
integer-factor nearest upsampling.

Under ``ops.bands.spatial_axis`` ``resize_bilinear`` (half-pixel centres)
runs on one H band; nearest upsampling is band-local as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.bands import active_spatial_axis
from text_segmentation_image_inpainting_tpu_torch.ops.conv import to_nchw, to_nhwc


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], *,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (N, H, W, C) to (N, out_h, out_w, C).

    ``align_corners=False``: half-pixel centres (``F.interpolate``).
    ``align_corners=True``: sample positions i * (H-1)/(out_h-1), computed
    as the JAX package computes them (in float32 or wider, rows first,
    then columns), so the two agree to the last bits.
    """
    oh, ow = out_hw
    n, h, w, c = x.shape
    if (oh, ow) == (h, w):
        return x
    ring = active_spatial_axis()
    if ring is not None:
        return _resize_band(ring, x, oh, ow, align_corners)
    if not align_corners:
        out = F.interpolate(
            to_nchw(x), size=(oh, ow), mode="bilinear", align_corners=False, antialias=False
        )
        return to_nhwc(out)
    dtype = torch.promote_types(x.dtype, torch.float32)

    def axis_weights(in_size: int, out_size: int):
        if out_size == 1:
            src = torch.zeros(1, dtype=dtype, device=x.device)
        else:
            src = torch.arange(out_size, dtype=dtype, device=x.device) * (
                (in_size - 1) / (out_size - 1))
        lo = torch.floor(src).long().clamp(0, in_size - 1)
        hi = (lo + 1).clamp(0, in_size - 1)
        return lo, hi, src - lo.to(dtype)

    ylo, yhi, yf = axis_weights(h, oh)
    xlo, xhi, xf = axis_weights(w, ow)
    xf32 = x.to(dtype)
    yf, xf = yf[None, :, None, None], xf[None, None, :, None]
    rows = xf32[:, ylo] * (1 - yf) + xf32[:, yhi] * yf
    out = rows[:, :, xlo] * (1 - xf) + rows[:, :, xhi] * xf
    return out.to(x.dtype)


def _resize_band(ring, x: torch.Tensor, oh: int, ow: int, align_corners: bool) -> torch.Tensor:
    """``resize_bilinear`` (half-pixel centres) of one H band by an integer
    factor f in H: the band takes one source row from each real neighbour
    and none at the page's ends (``ends="none"``), is resized whole by f,
    and loses the f output rows of each halo row. An output row's two
    source rows then lie in the band or its halo, at the same fractional
    weights as in the whole page (f a power of 2: every position exact), and
    at the page's ends torch clamps to the same edge row. Zero rows there
    would be blended in, and even copies of the edge row change the bits:
    (1 - l) a + l a is not a in floating point."""
    h = x.shape[1]
    if align_corners:
        raise ValueError("resize_bilinear under spatial_axis takes align_corners=False only")
    if oh % h:
        raise ValueError(f"resize_bilinear under spatial_axis needs an integer H factor, got "
                         f"{h} -> {oh}")
    f = oh // h
    top = 0 if ring.rank == 0 else 1
    bottom = 0 if ring.rank == ring.bands - 1 else 1
    ext = ring.exchange_rows(x, 1, 1, ends="none")
    out = F.interpolate(to_nchw(ext), size=((h + top + bottom) * f, ow), mode="bilinear",
                        align_corners=False, antialias=False)
    return to_nhwc(out[:, :, top * f: top * f + oh])


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Exact integer-factor nearest upsampling of (N, H, W, C)."""
    if factor == 1:
        return x
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)
