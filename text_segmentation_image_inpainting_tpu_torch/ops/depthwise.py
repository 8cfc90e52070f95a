"""Depthwise convolution whose weight gradient is kernel K6.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/depthwise.py``.
The forward is the plain depthwise conv (``ops/conv.py::conv2d``, cuDNN on
the card, as JAX leaves it to XLA). The backward computes dx with the
library's data gradient, ``aten::convolution_backward`` on channels-last
views of the NHWC tensors (cuDNN's dgrad on the card, no layout copy),
which is what JAX computes outside Pallas as the same conv with the
spatially flipped kernel; and dW with
``ops/kernels/depthwise_wgrad.py::depthwise_wgrad`` (K6 on CUDA, its plain
version on the CPU).

``ConvBNAct`` routes a conv here when ``supports`` holds, which needs
``USE_CUSTOM_WGRAD``. It is off by default, as in JAX. JAX reads the flag
while it traces, so a jitted function keeps the value it was traced with;
the port reads it at every forward, so flipping it takes effect at the
next call. The parameters are the same either way: only the weight
gradient's computation changes.
"""

from __future__ import annotations

import torch

from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d, to_nchw, torch_same_padding
from text_segmentation_image_inpainting_tpu_torch.ops.kernels.depthwise_wgrad import (
    depthwise_wgrad,
)

USE_CUSTOM_WGRAD: bool = False

# JAX's scope: C of at least one 128-lane channel tile (``_TC`` in
# ops/pallas/depthwise_wgrad.py), so both packages route the same layers.
MIN_CHANNELS = 128


def supports(features: int, groups: int, cin: int, kernel_size: int, stride: int) -> bool:
    """True when the K6 path covers this conv: the flag is on, the conv is
    depthwise (groups == features == cin), stride 1, odd k, C >= 128."""
    if not USE_CUSTOM_WGRAD:
        return False
    return (
        groups == features == cin
        and stride == 1
        and kernel_size % 2 == 1
        and features >= MIN_CHANNELS
    )


class DepthwiseConv2d(torch.autograd.Function):
    """Stride-1 torch-'same' depthwise conv of NHWC ``x`` with the OIHW
    weight (C, 1, k, k), computed in ``x.dtype``; dW by K6."""

    @staticmethod
    def forward(ctx, x, weight, dilation):
        ctx.save_for_backward(x, weight)
        ctx.dilation = dilation
        p = torch_same_padding(weight.shape[-1], dilation)
        return conv2d(x, weight, padding=p, dilation=dilation, groups=x.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        d, k, c = ctx.dilation, weight.shape[-1], x.shape[-1]
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            p = torch_same_padding(k, d)[0]
            dx = torch.ops.aten.convolution_backward(
                to_nchw(dy), to_nchw(x.contiguous()), weight.to(dy.dtype), None, [1, 1], [p, p],
                [d, d], False, [0, 0], c, [True, False, False])[0]
            dx = dx.permute(0, 2, 3, 1).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # (k, k, 1, C) f32 -> (C, 1, k, k), rounded once to the weight's dtype;
            # K6's result is a (C, k*k) tensor's view, so contiguous() copies nothing
            dw = depthwise_wgrad(x, dy, k, d).permute(3, 2, 0, 1).contiguous().to(weight.dtype)
        return dx, dw, None


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Depthwise conv with K6's weight gradient. x (N, H, W, C), weight
    (C, 1, k, k) with k odd, both in the compute dtype (the caller casts
    the f32 parameter, so dW comes back in that dtype, as in JAX)."""
    return DepthwiseConv2d.apply(x, weight, dilation)
