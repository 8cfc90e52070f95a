"""2-D convolution with torch padding semantics on NHWC tensors.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/conv.py``.
Tensors keep the JAX layout (N, H, W, C) at every function boundary.
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is an NCHW view in
``torch.channels_last`` memory, so cuDNN runs its NHWC kernels and the
result permutes back to contiguous NHWC without a copy. Weights stay in
torch's OIHW layout (the state_dict layout).

Under ``ops.bands.spatial_axis`` ``conv2d`` runs on one H band: it takes
its halo rows from the other bands (``bands.conv_halo``) and convolves
with H padding 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.bands import active_spatial_axis, conv_halo

IntOrPair = Union[int, Tuple[int, int], Sequence[int]]


def _pair(v: IntOrPair) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def torch_same_padding(kernel_size: IntOrPair, dilation: IntOrPair = 1) -> Tuple[int, int]:
    """Padding a torch user would pass as ``padding=k//2`` (per dim, dilated)."""
    kh, kw = _pair(kernel_size)
    dh, dw = _pair(dilation)
    return (dh * (kh - 1) // 2, dw * (kw - 1) // 2)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C, H, W) view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H, W, C); contiguous NHWC without a copy when x is channels_last."""
    return x.permute(0, 2, 3, 1).contiguous()


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: IntOrPair = 1,
    padding: IntOrPair = 0,
    dilation: IntOrPair = 1,
    groups: int = 1,
) -> torch.Tensor:
    """``F.conv2d`` on NHWC ``x`` with OIHW ``weight``, computed in ``x.dtype``.

    Weight and bias are cast to ``x.dtype``; the bias is added after the
    conv output is rounded to ``x.dtype``, as flax ``nn.Conv`` does. Under
    ``spatial_axis`` x is one H band (torch-same H padding only).
    """
    ring = active_spatial_axis()
    if ring is not None:
        s, p, d = _pair(stride), _pair(padding), _pair(dilation)
        (x,) = conv_halo(ring, (x,), weight.shape[2], s[0], p[0], d[0])
        padding = (0, p[1])
    return conv2d_local(x, weight, bias, stride=stride, padding=padding, dilation=dilation,
                        groups=groups)


def conv2d_local(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: IntOrPair = 1,
    padding: IntOrPair = 0,
    dilation: IntOrPair = 1,
    groups: int = 1,
) -> torch.Tensor:
    """``conv2d`` on ``x`` as it is, whatever the band context: for a
    caller that has taken its halo already (``partial_conv2d``)."""
    out = F.conv2d(
        to_nchw(x), weight.to(x.dtype), None,
        stride=_pair(stride), padding=_pair(padding), dilation=_pair(dilation), groups=groups,
    )
    out = to_nhwc(out)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def conv_output_size(size: int, kernel: int, stride: int, padding: int, dilation: int = 1) -> int:
    """Torch Conv2d output-size formula (floor)."""
    eff = dilation * (kernel - 1) + 1
    return (size + 2 * padding - eff) // stride + 1
