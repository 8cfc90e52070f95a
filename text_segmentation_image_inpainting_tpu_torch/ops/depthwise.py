"""The depthwise conv: its forward and stride-1 dx on the depthwise kernel, dW on K6.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/depthwise.py``.
``depthwise_conv2d`` is every depthwise conv of the segmenters
(``models/mobilenet_v2.py::ConvBNAct``), with torch-'same' padding. It
routes by what its input shows:

* a CUDA bf16 or f32 tensor that ``ops/kernels/depthwise_conv.py::in_scope``
  takes (k 3, stride 1 or 2, 16-byte pixels) runs the forward on the
  depthwise kernel (``csrc/depthwise_conv.cu``) and counts ``dw.kernel``;
  where no input needs a gradient (the served pipeline) the kernel is
  launched directly, else through ``DepthwiseConv2d``, whose stride-1 dx
  is the same kernel with the taps flipped. Nothing falls back;
* anything else (a CPU or f64 tensor, another window) takes the plain
  version, ``depthwise_conv2d_plain`` (``F.conv2d``, cuDNN on the card), and
  counts ``dw.plain``.

The stride-2 dx, and dW outside K6, are ``aten::convolution_backward``
(cuDNN's dgrad and wgrad on the card), one call for both. dW is
``ops/kernels/depthwise_wgrad.py::depthwise_wgrad`` (K6 on CUDA, its plain
version on the CPU) where ``supports`` holds, which needs
``USE_CUSTOM_WGRAD``; on the CPU only that case takes the Function. The
flag is off by default, as in JAX. JAX reads it while it traces, so a
jitted function keeps the value it was traced with; the port reads it at
every forward, so flipping it takes effect at the next call. The
parameters are the same either way: only the weight gradient's
computation changes.

Under ``ops.bands.spatial_axis`` x is one H band: it takes its halo rows
(``bands.conv_halo``) and convolves with H padding 0, as ``ops/conv.py``
does; the weight gradient then takes the library's route.
"""

from __future__ import annotations

import torch

from text_segmentation_image_inpainting_tpu_torch.ops.bands import active_spatial_axis, conv_halo
from text_segmentation_image_inpainting_tpu_torch.ops.conv import to_nchw, torch_same_padding
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_conv as kdc
from text_segmentation_image_inpainting_tpu_torch.ops.kernels.depthwise_wgrad import (
    depthwise_wgrad,
)
from text_segmentation_image_inpainting_tpu_torch.utils.profiling import count

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
    """The depthwise conv of NHWC ``x`` with the (C, 1, k, k) ``weight``
    (any float dtype, read as cast to x's), stride ``s``, dilation ``d``,
    zero padding (ph, pw); the forward on the kernel where ``kernel``, dW
    on K6 where ``k6`` (torch-'same' padding, stride 1), the rest as the
    module's note says. dW comes back rounded once to x's dtype, in the
    weight's."""

    @staticmethod
    def forward(ctx, x, weight, s, d, ph, pw, kernel, k6):
        ctx.save_for_backward(x, weight)
        ctx.geom, ctx.kernel, ctx.k6 = (s, d, ph, pw), kernel, k6
        if kernel:
            return kdc.depthwise_conv2d_fused(x, weight, s, d, (ph, pw))
        return kdc.depthwise_conv2d_plain(x, weight, s, d, (ph, pw))

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        s, d, ph, pw = ctx.geom
        k, c = weight.shape[-1], x.shape[-1]
        dy = dy.contiguous()
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = dw = None
        if need_x and ctx.kernel and s == 1:
            # at stride 1 dx is the conv of dy with the taps flipped
            dx = kdc.depthwise_conv2d_fused(dy, weight, 1, d, (d * (k - 1) - ph, d * (k - 1) - pw),
                                            flip=True)
        lib_x, lib_w = need_x and dx is None, need_w and not ctx.k6
        if lib_x or lib_w:
            gx, gw, _ = torch.ops.aten.convolution_backward(
                to_nchw(dy), to_nchw(x.contiguous()), weight.to(dy.dtype), None, [s, s],
                [ph, pw], [d, d], False, [0, 0], c, [lib_x, lib_w, False])
            if lib_x:
                dx = gx.permute(0, 2, 3, 1).to(x.dtype)
            if lib_w:
                dw = gw.to(weight.dtype)
        if need_w and ctx.k6:
            # (k, k, 1, C) f32 -> (C, 1, k, k), rounded once to x's dtype;
            # K6's result is a (C, k*k) tensor's view, so contiguous() copies nothing
            dw = depthwise_wgrad(x, dy, k, d).permute(3, 2, 0, 1).contiguous().to(x.dtype)
            dw = dw.to(weight.dtype)
        return dx, dw, None, None, None, None, None, None


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor, dilation: int = 1,
                     stride: int = 1) -> torch.Tensor:
    """The depthwise k x k conv (k odd) of x (N, H, W, C) with the (C, 1, k,
    k) ``weight``, torch-'same' padding, computed in x's dtype with the
    weight cast to it; dW comes back in the weight's dtype. Routes as the
    module's note says."""
    c, k = x.shape[-1], weight.shape[-1]
    ph = pw = torch_same_padding(k, dilation)[0]
    ring = active_spatial_axis()
    if ring is not None:
        (x,) = conv_halo(ring, (x,), k, stride, ph, dilation)
        ph = 0
    kernel = kdc.in_scope(x, k, stride)
    k6 = supports(c, c, c, k, stride) and ph == pw
    count("dw.kernel" if kernel else "dw.plain")
    if (kernel or k6) and torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return DepthwiseConv2d.apply(x, weight, stride, dilation, ph, pw, kernel, k6)
    if kernel:
        return kdc.depthwise_conv2d_fused(x, weight, stride, dilation, (ph, pw))
    return kdc.depthwise_conv2d_plain(x, weight, stride, dilation, (ph, pw))
