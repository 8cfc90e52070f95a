"""Fused partial-convolution kernels K1 and K2, their backward K3, and the
plain version.

Counterpart of
``text_segmentation_image_inpainting_tpu/ops/pallas/partial_conv_kernel.py``.
The CUDA sources are ``csrc/partial_conv.cu`` (see the note at their
top): K1 is an NHWC implicit GEMM on Hopper's ``wgmma`` for Cout >= 8
(a producer warpgroup gathering tiles with ``cp.async`` into a ring of
shared stages; a halo form that gathers a window row once for its three
taps; split K where the tile grid does not fill the card: ``k1_plan``),
K2 a CUDA-core kernel for Cout <= 7. Scope: stride 1, dilation 1, square
kernel, G in {1, 2} mask groups, bf16.

``partial_conv2d_fused`` is differentiable: ``PartialConvFunction``
runs K1 or K2 forward and K3 backward, the counterpart of the custom VJP
``partial_conv2d_pallas`` (``_fwd`` / ``_bwd``, ``partial_conv_kernel.py:542-676``).
The forward takes the plain version only for a tensor on the CPU. On a
CUDA tensor it launches K1 or K2, or raises; nothing falls back.
``K1_LAUNCHES`` / ``K2_LAUNCHES`` count the launches.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

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

_BK = 64  # K1's K step: one tap x 64 channels; the re-laid weights pad Cin to it
_SMS = 132  # streaming multiprocessors of an H100 SXM: K1's grid fills at least one wave
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


def k1_channels(group_sizes: Sequence[int]) -> Tuple[int, int, int]:
    """K1's channel layout of x: (gb, cin_x, cin_p). Each mask group
    starts on a multiple of 8 channels, so a 16-byte chunk of x lies in one
    group: group 1 starts at ``gb``, x has ``cin_x`` channels (a multiple of
    8), and the weights' K axis is padded to ``cin_p``, a multiple of the
    64-channel K step. Equal to the layer's own layout when every group
    size is a multiple of 8, as at every U-Net level."""
    s0 = group_sizes[0]
    gb = -(-s0 // 8) * 8
    cin_x = gb + (-(-group_sizes[1] // 8) * 8 if len(group_sizes) == 2 else 0)
    return gb, cin_x, -(-cin_x // _BK) * _BK


class K1Plan(NamedTuple):
    """How K1 runs one call: the halo form or the plain gather, the CTA
    tile (BM pixels x BN channels) and the number of K splits."""

    halo: bool
    bm: int
    bn: int
    splits: int

    def steps(self, cin_p: int, k: int) -> int:
        """K steps of one tile: (tap, 64 channels), or in the halo form
        (window row, 64 channels) with the row's k taps in one step."""
        return (k if self.halo else k * k) * cin_p // _BK


def k1_plan(n: int, h: int, w: int, cout: int, cin_p: int, k: int, pad: int) -> K1Plan:
    """K1's plan for N images of H x W, Cout output channels, Cin_p
    channels (``k1_channels``), a k x k window and ``pad``: a pure
    function of the shape, the same on every call.

    The halo form (``csrc/partial_conv.cu::pconv_k1_halo``) where it
    applies and Cout <= 128: a 3 x 3 same-size window, a width of 64 or a
    multiple of 128 and H * W a multiple of 128 (dec2 and dec1 of the
    U-Net); BM 256 for BN 64 where the geometry and the grid allow (dec1),
    else 128. Else the plain gather, whose time is the operand tiles it
    moves from L2 into shared memory: the tile (BM x BN) and the number of
    K splits that give the fewest waves x K steps x stage bytes, plus the
    split partials' round trip (``_k1_gather_cost``). A grid of 132 tiles
    or more never splits; a smaller one splits K into ``splits`` CTAs per
    tile, so that the grid holds at least 132 CTAs, each over a nonempty
    contiguous range of K steps (``k1_split_ranges``)."""
    cout_p = -(-cout // 8) * 8
    p = n * (h + 2 * pad - k + 1) * (w + 2 * pad - k + 1)

    def tiles(bm, bn):
        return -(-p // bm) * -(-cout_p // bn)

    def halo_fits(bm):  # each m64 tile in one image row, no tile across two images
        return (k == 3 and pad == 1 and w % 64 == 0 and (w % bm == 0 or bm % w == 0)
                and (h * w) % bm == 0)

    if cout_p <= 128 and halo_fits(128):
        bn = 128 if cout_p > 64 else 64
        bm = 256 if bn == 64 and halo_fits(256) and tiles(256, bn) >= _SMS else 128
        plan, t = K1Plan(True, bm, bn, 1), tiles(bm, bn)
        if t >= _SMS:
            return plan
        return plan._replace(splits=min(plan.steps(cin_p, k), -(-_SMS // t)))
    best = None
    for bm, bn in _K1_GATHER_TILES:
        if bn > 64 and bn // 2 >= cout_p:  # at least half the tile's channels real
            continue
        t = tiles(bm, bn)
        steps = K1Plan(False, bm, bn, 1).steps(cin_p, k)
        first = 1 if t >= _SMS else min(steps, -(-_SMS // t))
        for splits in range(first, (first if t >= _SMS else min(steps, 4 * first)) + 1):
            cost = _k1_gather_cost(t, steps, bm, bn, splits, p, cout_p)
            if best is None or cost < best[0]:
                best = (cost, K1Plan(False, bm, bn, splits))
    return best[1]


# The gather form's CTA tiles, (BM, BN), in the order that breaks ties.
_K1_GATHER_TILES = ((128, 256), (256, 128), (128, 128), (256, 64), (128, 64))
# Operand traffic from L2 into shared memory that one SM sustains in the
# gather form, and the device memory rate for the split partials (an H100
# SXM; chip_smoke.py measured 2.1-3.5 TB/s over the card, PERF.md).
_K1_SM_BYTES_PER_S = 3.0e12 / _SMS
_HBM_BYTES_PER_S = 3.35e12


def _k1_gather_cost(t: int, steps: int, bm: int, bn: int, splits: int, p: int,
                    cout_p: int) -> float:
    """Estimated seconds of the gather form: waves of one CTA per SM x K
    steps per CTA x the bytes of one stage, plus writing and reading the
    f32 partials when K is split."""
    waves = -(-t * splits // _SMS)
    cost = waves * -(-steps // splits) * (bm + bn) * _BK * 2 / _K1_SM_BYTES_PER_S
    if splits > 1:
        cost += 2 * splits * p * cout_p * 4 / _HBM_BYTES_PER_S
    return cost


def k1_split_ranges(steps: int, splits: int) -> list:
    """The K steps [begin, end) that CTA z of a split launch takes; the
    kernel computes the same ``z * steps // splits`` bounds."""
    return [(z * steps // splits, (z + 1) * steps // splits) for z in range(splits)]


def k1_weight_relayout(weight: torch.Tensor, group_sizes: Sequence[int]) -> torch.Tensor:
    """OIHW weights -> K1's (k*k, Cout_p, Cin_p) bf16: per tap, one row of
    Cin_p channels per output channel (the K-major B operand of
    ``wgmma``), channels placed as ``k1_channels`` lays x out, zero
    elsewhere. Where no padding is needed (every U-Net level) it is one
    permute copy."""
    cout, cin, kh, kw = weight.shape
    gb, cin_x, cin_p = k1_channels(group_sizes)
    cout_p = -(-cout // 8) * 8
    wt = weight.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(kh * kw, cout, cin)
    if (cout_p, cin_p, gb) == (cout, cin, group_sizes[0]):
        return wt.contiguous()
    out = torch.zeros((kh * kw, cout_p, cin_p), dtype=torch.bfloat16, device=weight.device)
    s0 = group_sizes[0]
    out[:, :cout, :s0] = wt[..., :s0]
    out[:, :cout, gb:gb + cin - s0] = wt[..., s0:]
    return out


def k1_input_relayout(x: torch.Tensor, group_sizes: Sequence[int]) -> torch.Tensor:
    """x as K1 reads it: (N, H, W, cin_x), each group from a multiple of 8
    channels (``k1_channels``), zero between, 16-byte aligned. ``x`` itself
    where it already is (every U-Net level)."""
    gb, cin_x, _ = k1_channels(group_sizes)
    s0 = group_sizes[0]
    if cin_x == x.shape[-1] and gb == s0:
        return x if x.data_ptr() % 16 == 0 else x.clone()
    out = x.new_zeros((*x.shape[:3], cin_x))
    out[..., :s0] = x[..., :s0]
    out[..., gb:gb + x.shape[-1] - s0] = x[..., s0:]
    return out


def _launch_k1(x, mask, weight, bias, group_sizes, padding):
    """K1 (``csrc/partial_conv.cu``: ``pconv_k1``, ``pconv_k1_halo``, as
    ``k1_plan`` says), with the weights re-laid in this call
    (``k1_weight_relayout``).

    The mask must be binary; this is not checked (a check would cost a
    device-to-host sync per call). A tap whose group mask is 0
    contributes nothing (the copy zero-fills it) and any other value
    takes x as it is: that equals x*M exactly for binary masks, which are
    all the U-Net makes, and differs from the plain version for any other
    value. msum and M' count the mask values as they are. Every other
    input outside the scope raises (``_check_inputs``)."""
    global K1_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    n, h, w, cin, g, cout, k, pad, hout, wout = _check_inputs(x, mask, weight, bias, group_sizes, padding)
    lib = load_library()
    gb, cin_x, cin_p = k1_channels(group_sizes)
    cout_p = -(-cout // 8) * 8
    p = n * hout * wout
    plan = k1_plan(n, h, w, cout, cin_p, k, pad)
    xk = k1_input_relayout(x, group_sizes)
    wk = k1_weight_relayout(weight, group_sizes)
    b = None
    if bias is not None:
        b = torch.zeros((cout_p,), dtype=torch.float32, device=x.device)
        b[:cout] = bias.to(x.dtype).float()
    y = torch.empty((n, hout, wout, cout), dtype=x.dtype, device=x.device)
    m_out = torch.empty((n, hout, wout, 1), dtype=x.dtype, device=x.device)
    part = None
    if plan.splits > 1:
        part = torch.empty((plan.splits, p, cout_p), dtype=torch.float32, device=x.device)
    s0, s1 = _sizes(group_sizes)
    code = lib.tsii_pconv_k1(
        xk.data_ptr(), mask.data_ptr(), wk.data_ptr(), 0 if b is None else b.data_ptr(),
        y.data_ptr(), m_out.data_ptr(), 0 if part is None else part.data_ptr(),
        n, h, w, cin, g, s0, s1, hout, wout, cout, cin_x, gb, cin_p, cout_p, k, pad, plan.splits,
        plan.bm, plan.bn, int(plan.halo), _stream(),
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
