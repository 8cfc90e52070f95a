"""Partial convolution (Liu et al. 2018, arXiv:1804.07723), functional op.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/partial_conv.py``.
For each output window::

    y  = W^T (X . M) * sum(1) / sum(M) + b     if sum(M) > 0
    y  = 0                                      otherwise
    M' = 1[sum(M) > 0]

Masks are grouped, (N, H, W, G): group g covers a contiguous block of
``group_sizes[g]`` feature channels, so ``sum(M) = sum_g size_g *
window_sum(M_g)`` and ``sum(1) = k*k*Cin``. Features are NHWC, weights
OIHW.

``partial_conv2d`` routes by static shape only: stride 1, dilation 1 and
a square kernel go to the fused kernels (``ops/kernels/partial_conv.py``:
K1, or K2 when Cout <= 7, with K3 as their backward), which take their
plain version on a CPU tensor and launch the CUDA kernel, or raise, on a
CUDA tensor. Every other configuration (the U-Net's stride-2 encoder)
runs the plain cuDNN formulation ``_partial_conv2d_plain``, the
counterpart of JAX's ``_partial_conv2d_xla``, differentiated by autograd.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.conv import IntOrPair, _pair, conv2d, to_nchw, to_nhwc


def mask_window_sum(
    mask: torch.Tensor,
    group_sizes: Sequence[int],
    kernel_size: Tuple[int, int],
    *,
    stride: Tuple[int, int],
    padding: Tuple[int, int],
    dilation: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """sum(M) per output window, weighted by channel-group sizes.

    mask: (N, H, W, G) in {0, 1}. Returns (N, H', W', 1) float32 (exact:
    every partial sum is an integer far below 2**24).
    """
    kh, kw = kernel_size
    g = mask.shape[-1]
    if len(group_sizes) != g:
        raise ValueError(f"{len(group_sizes)} group sizes for a mask of {g} groups")
    w = torch.tensor(group_sizes, dtype=torch.float32, device=mask.device)
    w = w.reshape(1, g, 1, 1).expand(1, g, kh, kw)
    out = F.conv2d(
        to_nchw(mask.float()), w, None, stride=stride, padding=padding, dilation=dilation
    )
    return to_nhwc(out)


def broadcast_mask(mask: torch.Tensor, group_sizes: Sequence[int]) -> torch.Tensor:
    """Expand (N,H,W,G) grouped mask to per-channel (N,H,W,sum(group_sizes))."""
    parts = [
        mask[..., g : g + 1].expand(*mask.shape[:-1], size) for g, size in enumerate(group_sizes)
    ]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def apply_mask(x: torch.Tensor, mask: torch.Tensor, group_sizes: Sequence[int]) -> torch.Tensor:
    """x * broadcast_mask(mask), each channel group times its own mask channel."""
    if len(group_sizes) == 1:
        return x * mask
    parts = []
    off = 0
    for gi, size in enumerate(group_sizes):
        parts.append(x[..., off : off + size] * mask[..., gi : gi + 1])
        off += size
    return torch.cat(parts, dim=-1)


def pconv_epilogue(feat, msum, bias, window_size: float, out_dtype):
    """Renorm / bias / zero epilogue: ``feat`` in the accumulation dtype, ``msum`` f32."""
    acc_dtype = feat.dtype
    valid = msum > 0
    scale = window_size / torch.clamp(msum, min=1.0)
    out = feat * scale.to(acc_dtype)
    if bias is not None:
        out = out + bias.to(acc_dtype)
    out = torch.where(valid, out.to(out_dtype), torch.zeros((), dtype=out_dtype, device=out.device))
    return out, valid.to(out_dtype)


def in_kernel_scope(stride: Tuple[int, int], dilation: Tuple[int, int], weight_shape) -> bool:
    """The fused kernels' scope: stride 1, dilation 1, square kernel."""
    return stride == (1, 1) and dilation == (1, 1) and weight_shape[2] == weight_shape[3]


def partial_conv2d(
    x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    group_sizes: Sequence[int] | None = None,
    stride: IntOrPair = 1,
    padding: IntOrPair = 0,
    dilation: IntOrPair = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused partial convolution.

    Args:
      x: (N, H, W, Cin) features.
      mask: (N, H, W, G) binary validity mask (1 = valid pixel).
      weight: (Cout, Cin, kh, kw) OIHW.
      bias: optional (Cout,). Not renormalised; zeroed in empty windows.
      group_sizes: channel count covered by each mask group; defaults to
        one group covering all Cin channels.

    Returns:
      (y, new_mask): y (N, H', W', Cout); new_mask (N, H', W', 1) in
      x.dtype, 1 where the window saw any valid pixel.
    """
    cin = weight.shape[1]
    if group_sizes is None:
        group_sizes = (cin,)
    if sum(group_sizes) != cin or mask.shape[-1] != len(group_sizes):
        raise ValueError(f"group_sizes {tuple(group_sizes)} must sum to Cin={cin} and match "
                         f"the mask's {mask.shape[-1]} groups")
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    mask = mask.to(x.dtype)
    if in_kernel_scope(s, d, weight.shape):
        from text_segmentation_image_inpainting_tpu_torch.ops.kernels.partial_conv import (
            partial_conv2d_fused,
        )

        return partial_conv2d_fused(
            x, mask, weight, bias, group_sizes=tuple(group_sizes), padding=p
        )
    return _partial_conv2d_plain(x, mask, weight, bias, tuple(group_sizes), s, p, d)


def _partial_conv2d_plain(x, mask, weight, bias, group_sizes, stride, padding, dilation):
    """Two-conv formulation: the conv runs (and rounds) in ``x.dtype``,
    the epilogue in f32, as JAX's ``_partial_conv2d_xla``."""
    _, cin, kh, kw = weight.shape
    masked = apply_mask(x, mask, group_sizes)
    acc_dtype = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    feat = conv2d(masked, weight, stride=stride, padding=padding, dilation=dilation).to(acc_dtype)
    msum = mask_window_sum(
        mask, group_sizes, (kh, kw), stride=stride, padding=padding, dilation=dilation
    )
    return pconv_epilogue(feat, msum, bias, float(kh * kw * cin), x.dtype)
