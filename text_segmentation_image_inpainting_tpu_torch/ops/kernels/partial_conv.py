"""Fused partial-convolution kernels K1 and K2, their backward K3, and the
plain version.

Counterpart of
``text_segmentation_image_inpainting_tpu/ops/pallas/partial_conv_kernel.py``.
The CUDA sources are ``csrc/partial_conv.cu`` (see the note at their
top): K1 is an NHWC implicit GEMM on the tensor cores for Cout >= 8,
K2 a CUDA-core kernel for Cout <= 7. Scope: stride 1, dilation 1,
square kernel, G in {1, 2} mask groups, bf16.

``partial_conv2d_fused`` is differentiable: ``PartialConvFunction``
runs K1 or K2 forward and K3 backward, the counterpart of the custom VJP
``partial_conv2d_pallas`` (``_fwd`` / ``_bwd``, ``partial_conv_kernel.py:542-676``).
The forward takes the plain version only for a tensor on the CPU. On a
CUDA tensor it launches K1 or K2, or raises; nothing falls back.
``K1_LAUNCHES`` / ``K2_LAUNCHES`` count the launches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.conv import to_nchw, to_nhwc
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import (
    apply_mask,
    mask_window_sum,
    pconv_epilogue,
)

K1_LAUNCHES = 0
K2_LAUNCHES = 0

_BK = 32  # K1's channel chunk: the re-laid weights pad Cin to a multiple of it
_K2_MAX_COUT = 7


def partial_conv2d_reference(
    x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    *,
    group_sizes: Sequence[int],
    padding: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version with exactly the kernels' semantics.

    x * M in x.dtype (exact for binary masks); weight and bias rounded to
    x.dtype; the conv accumulates in f32 and stays f32 through the
    epilogue; one cast at the end. (JAX's XLA twin instead rounds the
    conv output to x.dtype before the epilogue.)
    """
    _, cin, kh, kw = weight.shape
    masked = apply_mask(x, mask.to(x.dtype), group_sizes)
    feat = F.conv2d(to_nchw(masked).float(), weight.to(x.dtype).float(), padding=padding)
    msum = mask_window_sum(mask, group_sizes, (kh, kw), stride=(1, 1), padding=padding)
    b = None if bias is None else bias.to(x.dtype).float()
    return pconv_epilogue(to_nhwc(feat), msum, b, float(kh * kw * cin), x.dtype)


def partial_conv2d_fused(
    x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    group_sizes: Sequence[int],
    padding: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stride-1 partial conv: K1 (Cout >= 8) or K2 (Cout <= 7) on CUDA,
    the plain version on the CPU; differentiable in x, weight and bias
    (K3). Shapes as ``ops.partial_conv.partial_conv2d``."""
    return PartialConvFunction.apply(x, mask, weight, bias, tuple(group_sizes), tuple(padding))


def _forward(x, mask, weight, bias, group_sizes, padding):
    if x.device.type == "cpu":
        return partial_conv2d_reference(
            x, mask, weight, bias, group_sizes=group_sizes, padding=padding
        )
    if weight.shape[0] <= _K2_MAX_COUT:
        return _launch_k2(x, mask, weight, bias, group_sizes, padding)
    return _launch_k1(x, mask, weight, bias, group_sizes, padding)


def partial_conv2d_backward(g, x, mask, weight, bias, group_sizes, padding,
                            needs=(True, True, True)):
    """K3: (dx, dW, db) of a stride-1 partial conv, given the cotangent
    ``g`` of y (the mask output gets none: it is binary).

    The counterpart of ``partial_conv_kernel.py::_bwd``: msum is
    recomputed, ``dacc = g * scale * valid`` is rounded to x.dtype, and
    the two products accumulate in f32 (cuDNN; JAX leaves them to XLA as
    well): dx = conv_transpose(dacc, W) * M, dW = corr(x * M, dacc), each
    rounded once to its input's dtype; db = sum(g * valid) in f32.
    ``needs`` says which of (dx, dW, db) to compute; the others are None.
    """
    _, cin, kh, kw = weight.shape
    msum = mask_window_sum(mask, group_sizes, (kh, kw), stride=(1, 1), padding=padding)
    valid = msum > 0
    scale = torch.where(valid, float(kh * kw * cin) / torch.clamp(msum, min=1.0), 0.0)
    dacc = to_nchw((g.float() * scale).to(x.dtype))
    mask_t = mask.to(x.dtype)
    dx = dw = db = None
    if needs[0]:
        dxm = torch.nn.grad.conv2d_input(
            (x.shape[0], cin, x.shape[1], x.shape[2]), weight.to(x.dtype), dacc, padding=padding
        )
        dx = apply_mask(to_nhwc(dxm), mask_t, group_sizes)
    if needs[1]:
        xm = to_nchw(apply_mask(x, mask_t, group_sizes))
        dw = torch.nn.grad.conv2d_weight(xm, weight.shape, dacc, padding=padding)
        dw = dw.to(weight.dtype)
    if needs[2] and bias is not None:
        db = (g.float() * valid).sum(dim=(0, 1, 2)).to(bias.dtype)
    return dx, dw, db


class PartialConvFunction(torch.autograd.Function):
    """Forward: K1/K2 (the plain version on the CPU). Backward: K3."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, group_sizes, padding):
        y, m_out = _forward(x, mask, weight, bias, group_sizes, padding)
        ctx.save_for_backward(x, mask, weight, bias)
        ctx.group_sizes, ctx.padding = group_sizes, padding
        ctx.mark_non_differentiable(m_out)
        return y, m_out

    @staticmethod
    def backward(ctx, g, _g_mask):
        x, mask, weight, bias = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, db = partial_conv2d_backward(
            g, x, mask, weight, bias, ctx.group_sizes, ctx.padding, (need[0], need[2], need[3])
        )
        return dx, None, dw, db, None, None


def _check_inputs(x, mask, weight, bias, group_sizes, padding):
    """Validate what the kernels take; returns the launch geometry."""
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got x on {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernels take bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, H, W, Cin) tensor, got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    g = len(group_sizes)
    if g not in (1, 2) or sum(group_sizes) != cin:
        raise ValueError(f"group_sizes {group_sizes} must be 1 or 2 groups summing to Cin={cin}")
    if mask.shape != (n, h, w, g) or mask.dtype != x.dtype or mask.device != x.device:
        raise ValueError(f"mask must be ({n}, {h}, {w}, {g}) {x.dtype} on {x.device}, "
                         f"got {tuple(mask.shape)} {mask.dtype} on {mask.device}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    cout, wcin, kh, kw = weight.shape
    if wcin != cin or kh != kw or weight.device != x.device:
        raise ValueError(f"weight {tuple(weight.shape)} on {weight.device} does not fit x {tuple(x.shape)}")
    if bias is not None and (bias.shape != (cout,) or bias.device != x.device):
        raise ValueError(f"bias must be ({cout},) on {x.device}, got {tuple(bias.shape)}")
    ph, pw = padding
    if ph != pw:
        raise ValueError(f"the kernels take symmetric square padding, got {padding}")
    hout, wout = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    if hout <= 0 or wout <= 0:
        raise ValueError(f"empty output for x {tuple(x.shape)}, k={kh}, padding={padding}")
    return n, h, w, cin, g, cout, kh, ph, hout, wout


def _sizes(group_sizes):
    return group_sizes[0], (group_sizes[1] if len(group_sizes) == 2 else 0)


def _stream() -> int:
    # Temporaries a wrapper allocates (re-laid weights, bias) are freed when
    # it returns, before the kernel has run. That is safe: the caching
    # allocator hands a freed block only to work queued after this launch
    # on the same stream.
    return torch.cuda.current_stream().cuda_stream


def _launch_k1(x, mask, weight, bias, group_sizes, padding):
    global K1_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    n, h, w, cin, g, cout, k, pad, hout, wout = _check_inputs(x, mask, weight, bias, group_sizes, padding)
    lib = load_library()
    cin_p = -(-cin // _BK) * _BK
    cout_p = -(-cout // 8) * 8
    # OIHW -> (k*k, Cin_p, Cout_p) bf16, zero padded: re-laid on every
    # call (a copy of the weights per launch; caching it is later work)
    wk = torch.zeros((k * k, cin_p, cout_p), dtype=torch.bfloat16, device=x.device)
    wk[:, :cin, :cout] = weight.to(torch.bfloat16).permute(2, 3, 1, 0).reshape(k * k, cin, cout)
    b = None
    if bias is not None:
        b = torch.zeros((cout_p,), dtype=torch.float32, device=x.device)
        b[:cout] = bias.to(x.dtype).float()
    y = torch.empty((n, hout, wout, cout), dtype=x.dtype, device=x.device)
    m_out = torch.empty((n, hout, wout, 1), dtype=x.dtype, device=x.device)
    vec_ok = int(cin % 8 == 0 and x.data_ptr() % 16 == 0)
    s0, s1 = _sizes(group_sizes)
    code = lib.tsii_pconv_k1(
        x.data_ptr(), mask.data_ptr(), wk.data_ptr(), 0 if b is None else b.data_ptr(),
        y.data_ptr(), m_out.data_ptr(), n, h, w, cin, g, s0, s1, hout, wout, cout,
        cin_p, cout_p, k, pad, vec_ok, _stream(),
    )
    check(lib, code, "K1 (partial conv, Cout >= 8)")
    K1_LAUNCHES += 1
    return y, m_out


def _launch_k2(x, mask, weight, bias, group_sizes, padding):
    global K2_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    n, h, w, cin, g, cout, k, pad, hout, wout = _check_inputs(x, mask, weight, bias, group_sizes, padding)
    lib = load_library()
    # OIHW -> (k*k, Cin, Cout) bf16, re-laid on every call
    wk = weight.to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()
    b = None if bias is None else bias.to(x.dtype).float().contiguous()
    y = torch.empty((n, hout, wout, cout), dtype=x.dtype, device=x.device)
    m_out = torch.empty((n, hout, wout, 1), dtype=x.dtype, device=x.device)
    s0, s1 = _sizes(group_sizes)
    code = lib.tsii_pconv_k2(
        x.data_ptr(), mask.data_ptr(), wk.data_ptr(), 0 if b is None else b.data_ptr(),
        y.data_ptr(), m_out.data_ptr(), n, h, w, cin, g, s0, s1, hout, wout, cout, k, pad,
        _stream(),
    )
    check(lib, code, "K2 (partial conv, Cout <= 7)")
    K2_LAUNCHES += 1
    return y, m_out
