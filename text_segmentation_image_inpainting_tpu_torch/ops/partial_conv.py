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

``partial_conv2d`` routes by static shape only, as JAX's ``_supported``
(``ops/pallas/partial_conv_kernel.py:532-539``) routes: stride 1,
dilation 1, a square kernel and an output height under 8 or a multiple
of 8 go to the fused kernels (``ops/kernels/partial_conv.py``: K1, or K2
when Cout <= 7, with K3 as their backward), which take their plain
version on a CPU tensor and launch the CUDA kernel, or raise, on a CUDA
tensor. Every other configuration (the U-Net's stride-2 encoder, an
output height such as 12) runs the plain cuDNN formulation
``_partial_conv2d_plain``, the counterpart of JAX's
``_partial_conv2d_xla``, differentiated by autograd: its conv rounds to
x's dtype before the f32 epilogue, as JAX's does there.

Under ``spatial_axis(ring)`` (``ops/bands.py``) every call runs on one H
band of a page: it first takes its halo rows from the other bands through
``ring`` and convolves with H padding 0 (``parallel/spatial.py``).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.bands import (  # noqa: F401 (re-exported)
    active_spatial_axis as _active_spatial_axis,
    conv_halo,
    spatial_axis,
)
from text_segmentation_image_inpainting_tpu_torch.ops.conv import (
    IntOrPair,
    _pair,
    conv2d_local,
    to_nchw,
    to_nhwc,
)


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
    w = _window_weights(tuple(group_sizes), kh, kw, mask.device)
    out = F.conv2d(
        to_nchw(mask.float()), w, None, stride=stride, padding=padding, dilation=dilation
    )
    return to_nhwc(out)


@functools.lru_cache(maxsize=64)
def _window_weights(group_sizes: Tuple[int, ...], kh: int, kw: int, device) -> torch.Tensor:
    """The window count's (1, G, kh, kw) f32 weights, group g's all
    ``group_sizes[g]``: built once per (sizes, window, device) and kept, so
    a call makes no host-to-device copy."""
    w = torch.tensor(group_sizes, dtype=torch.float32, device=device)
    return w.reshape(1, len(group_sizes), 1, 1).expand(1, len(group_sizes), kh, kw).contiguous()


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


def in_kernel_scope(stride: Tuple[int, int], dilation: Tuple[int, int], weight_shape,
                    h_out: int) -> bool:
    """The fused kernels' scope, JAX's ``_supported``: stride 1, dilation
    1, a square kernel, and an output height ``h_out`` (the page's, under
    ``spatial_axis``) under 8 or a multiple of 8."""
    return (stride == (1, 1) and dilation == (1, 1) and weight_shape[2] == weight_shape[3]
            and (h_out < 8 or h_out % 8 == 0))


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
      mask: (N, H, W, G) binary validity mask (1 = valid pixel). Binary
        is a contract, not checked: kernel K1 (CUDA, Cout >= 8) skips the
        taps whose mask is 0 and takes x as it is at every other value,
        so a soft mask gives other numbers there than x * M.
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
    ring = _active_spatial_axis()
    # the route is the page's: a band's output height is not the layer's
    h_page = x.shape[1] * (1 if ring is None else ring.bands)
    h_out = (h_page + 2 * p[0] - d[0] * (weight.shape[2] - 1) - 1) // s[0] + 1
    if ring is not None:  # one H band: take the halo rows, then H padding 0
        x, mask = conv_halo(ring, (x, mask), weight.shape[2], s[0], p[0], d[0])
        p = (0, p[1])
    if in_kernel_scope(s, d, weight.shape, h_out):
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
    feat = conv2d_local(masked, weight, stride=stride, padding=padding,
                        dilation=dilation).to(acc_dtype)
    msum = mask_window_sum(
        mask, group_sizes, (kh, kw), stride=stride, padding=padding, dilation=dilation
    )
    return pconv_epilogue(feat, msum, bias, float(kh * kw * cin), x.dtype)
