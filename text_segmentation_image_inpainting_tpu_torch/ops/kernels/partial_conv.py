"""Fused partial-convolution kernels K1 and K2, their backward K3, and the
plain version.

Counterpart of
``text_segmentation_image_inpainting_tpu/ops/pallas/partial_conv_kernel.py``.
The CUDA sources are ``csrc/partial_conv.cu`` (see the note at their
top): K1 is an NHWC implicit GEMM on Hopper's ``wgmma`` for Cout >= 8
(a producer warpgroup gathering tiles with ``cp.async`` into a ring of
shared stages; a halo form that gathers a window row once for its three
taps; split K where the tile grid does not fill the card: ``k1_plan``),
K2, for Cout <= 7, a GEMM with N padded to 8 on ``mma.sync`` that stages
its 2-byte-aligned pixels with 16-byte copies and re-lays them masked
(``k2_plan``). Scope: stride 1, dilation 1, square kernel, any number of
mask groups (past two, a table of them in device memory: ``group_table``),
bf16. Where K2 or K2F's templated form does not take a shape of that
scope (a window other than theirs, more input channels than K2F's ring
holds, three or more groups, K2's backward at a padding above k - 1), a
general form in the same source takes it (``pconv_gen_fwd_bf16`` /
``_f32``, ``pconv_gen_dx_bf16`` / ``_f32``, ``pconv_gen_dw_bf16`` / ``_f32``,
planned by ``gen_plan``), counted as the kernel it stands for; from the
routing cut (``K2_GEN_K``; K2F's backward past ``K2F_BWD_KS``) the general
forms take the shapes where they are the faster.
A float32 x takes the f32 form instead, as JAX's Pallas kernels take x's
dtype as it comes: SIMT FFMA, f32 accumulation,
no TF32 and no bf16 rounding (K1F at Cout >= 8: ``pconv_k1f_weights``
and ``pconv_f32_mask``, then ``pconv_k1f``, a register-blocked implicit
GEMM with a ``cp.async`` ring and split K, ``k1f_plan``; K2F at Cout <= 7:
``pconv_f32_relay`` and ``pconv_k2f``, whole input rows through a
``cp.async`` ring and runs of 3 output pixels a thread, ``k2f_plan``); its
backward is ``pconv_k3_prep`` and ``pconv_k3_mask`` in f32 around one f32
``convolution_backward`` with cuDNN's TF32 off for that call at Cout >= 8,
and at Cout <= 7 ``pconv_k3_prep``, ``pconv_f32_relay`` and
``pconv_k2f_bwd`` (dx and each CTA's part of dW in one pass,
``k2f_bwd_plan``), then ``pconv_colsum``. Any other dtype raises.

``partial_conv2d_fused`` is differentiable: ``PartialConvFunction``
runs K1 or K2 forward and K3 backward, the counterpart of the custom VJP
``partial_conv2d_pallas`` (``_fwd`` / ``_bwd``, ``partial_conv_kernel.py:542-676``).
K3 (``partial_conv2d_backward``) is, at Cout >= 8, ``pconv_k3_prep`` (the
scaled cotangent and db in one pass over g) and ``pconv_k3_mask`` (x * M
for the dW product; dx masked in place) around the two large products,
which stay one library call as JAX leaves them to XLA; at Cout <= 7 it is
one kernel, ``pconv_k2_bwd``. Forward and backward take the plain version
only for a tensor on the CPU. On a CUDA tensor they launch their kernels,
or raise; nothing falls back. ``K1_LAUNCHES`` / ``K2_LAUNCHES`` /
``K3_LAUNCHES`` count the launches (K3: one per layer backward), and
``K1F_LAUNCHES`` / ``K2F_LAUNCHES`` / ``K3F_LAUNCHES`` those of the f32
form (K1F at Cout >= 8, K2F at Cout <= 7), and ``K3F_HEAD_LAUNCHES`` those
of ``pconv_k2f_bwd`` (K3F at Cout <= 7). ``GEN_LAUNCHES`` /
``GEN_BWD_LAUNCHES`` count the general forms' launches besides.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import math
import threading
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
K3_LAUNCHES = 0
K1F_LAUNCHES = 0
K2F_LAUNCHES = 0
K3F_LAUNCHES = 0
K3F_HEAD_LAUNCHES = 0
# the general forms' launches (also counted under the kernel they stand
# for): forward (``pconv_gen_fwd_*``), backward (``pconv_gen_dx_*``/``_dw_*``)
GEN_LAUNCHES = 0
GEN_BWD_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()  # the H-sharded U-Net launches from one thread per shard

_BK = 64  # K1's K step: one tap x 64 channels; the re-laid weights pad Cin to it
_SMS = 132  # streaming multiprocessors of an H100 SXM: K1's grid fills at least one wave
_K2_MAX_COUT = 7
# K2's geometry, as csrc/partial_conv.cu has it (tests/test_torch_k2_plan.py
# holds the two against each other)
K2_TH, K2_TW = 8, 16  # a CTA's tile of pixels: rows x columns
K2_NPAD = 8  # Cout padded to the mma's N
K2_CB_MAX = 80  # most channels per block, a multiple of 16
K2_OPAD = 8  # operand row padding, elements
SMEM_LIMIT = 232448  # bytes of shared memory a CTA can take on Hopper


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
    x.dtype; the conv accumulates in f32 (in f64 for an f64 x, the truth
    the f32 forms are held to) and stays so through the epilogue; one cast
    at the end. (JAX's XLA twin instead rounds the conv output to x.dtype
    before the epilogue.)
    """
    _, cin, kh, kw = weight.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    masked = apply_mask(x, mask.to(x.dtype), group_sizes)
    feat = F.conv2d(to_nchw(masked).to(acc), weight.to(x.dtype).to(acc), padding=padding)
    msum = mask_window_sum(mask, group_sizes, (kh, kw), stride=(1, 1), padding=padding)
    b = None if bias is None else bias.to(x.dtype).to(acc)
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
    if x.dtype == torch.float32:
        return _launch_f32(x, mask, weight, bias, group_sizes, padding)
    if weight.shape[0] <= _K2_MAX_COUT:
        return _launch_k2(x, mask, weight, bias, group_sizes, padding)
    return _launch_k1(x, mask, weight, bias, group_sizes, padding)


def partial_conv2d_backward(g, x, mask, weight, bias, group_sizes, padding,
                            needs=(True, True, True)):
    """K3: (dx, dW, db) of a stride-1 partial conv, given the cotangent
    ``g`` of y (the mask output gets none: it is binary).

    The counterpart of ``partial_conv_kernel.py::_bwd``: msum is
    recomputed, ``dacc = g * scale * valid`` is rounded to x.dtype, and
    the two products accumulate in f32: dx = conv_transpose(dacc, W) * M,
    dW = corr(x * M, dacc), each rounded once to its input's dtype;
    db = sum(g * valid) in f32. ``needs`` says which of (dx, dW, db) to
    compute; the others are None, and no kernel or product runs for them.

    On a CUDA tensor: at Cout >= 8 ``pconv_k3_prep`` and ``pconv_k3_mask``
    around one library call of the two products (``_launch_k3``), at
    Cout <= 7 ``pconv_k2_bwd`` alone (``_launch_k2_bwd``); in f32 the
    former at Cout >= 8, and at Cout <= 7 ``pconv_k3_prep`` before
    ``pconv_k2f_bwd`` (``_launch_k2f_bwd``); a failed build or launch
    raises. On a CPU tensor the plain version."""
    needs = (needs[0], needs[1], needs[2] and bias is not None)
    if not any(needs):
        return None, None, None
    if x.device.type == "cpu":
        return partial_conv2d_backward_reference(g, x, mask, weight, bias, group_sizes, padding,
                                                 needs)
    if x.dtype == torch.float32:
        small = weight.shape[0] <= _K2_MAX_COUT
        out = (_launch_k2f_bwd if small else _launch_k3)(g, x, mask, weight, bias,
                                                         group_sizes, padding, needs)
        _count("K3F_LAUNCHES")
    elif weight.shape[0] <= _K2_MAX_COUT:
        out = _launch_k2_bwd(g, x, mask, weight, bias, group_sizes, padding, needs)
        _count("K3_LAUNCHES")
    else:
        out = _launch_k3(g, x, mask, weight, bias, group_sizes, padding, needs)
        _count("K3_LAUNCHES")
    return out


def partial_conv2d_backward_reference(g, x, mask, weight, bias, group_sizes, padding,
                                      needs=(True, True, True)):
    """K3's plain PyTorch version: the same arithmetic as
    ``partial_conv2d_backward`` in tensor operations, the two products on
    the library (in f64 throughout for an f64 x). The CPU path and the
    tests use it."""
    _, cin, kh, kw = weight.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    msum = mask_window_sum(mask, group_sizes, (kh, kw), stride=(1, 1), padding=padding)
    valid = msum > 0
    scale = torch.where(valid, float(kh * kw * cin) / torch.clamp(msum, min=1.0), 0.0)
    dacc = to_nchw((g.to(acc) * scale).to(x.dtype))
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
        db = (g.to(acc) * valid).sum(dim=(0, 1, 2)).to(bias.dtype)
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
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernels take bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, H, W, Cin) tensor, got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    g = len(group_sizes)
    if g < 1 or sum(group_sizes) != cin:
        raise ValueError(f"group_sizes {group_sizes} must be groups summing to Cin={cin}")
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
    if ph < 0 or pw < 0:
        raise ValueError(f"padding must be nonnegative, got {padding}")
    hout, wout = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    if hout <= 0 or wout <= 0:
        raise ValueError(f"empty output for x {tuple(x.shape)}, k={kh}, padding={padding}")
    return n, h, w, cin, g, cout, kh, (ph, pw), hout, wout


def _pads(pad) -> Tuple[int, int]:
    """(ph, pw) from one padding for both dimensions or a pair."""
    return (pad, pad) if isinstance(pad, int) else (int(pad[0]), int(pad[1]))


def _sizes(group_sizes):
    """(size0, size1), the kernels' two-group arguments (G > 2 reads the
    table instead)."""
    return group_sizes[0], (group_sizes[1] if len(group_sizes) >= 2 else 0)


def group_table(group_sizes: Sequence[int]) -> Tuple[int, ...]:
    """The kernels' group table (csrc/partial_conv.cu, at ``group_of``):
    the G sizes, each group's first channel in the layer (and Cin), each
    group's first channel in K1's x (and cin_x, ``k1_group_starts``)."""
    return (*group_sizes, *_layer_starts(group_sizes), *k1_group_starts(group_sizes))


@functools.lru_cache(maxsize=64)
def _group_table_on(group_sizes: Tuple[int, ...], device) -> torch.Tensor:
    """``group_table`` as an int32 tensor on ``device``, made once per
    (groups, device) and kept."""
    return torch.tensor(group_table(group_sizes), dtype=torch.int32, device=device)


def _groups_ptr(group_sizes, device, always: bool = False) -> int:
    """The device address of the group table, or 0 where the kernel takes
    the two sizes as arguments (G <= 2, unless ``always``)."""
    if len(group_sizes) <= 2 and not always:
        return 0
    return _group_table_on(tuple(group_sizes), device).data_ptr()


# The general forms' dW partials: at most this many f32 values (64 MiB).
GEN_PART_FLOATS = 1 << 24


def gen_chunks(pixels: int, elems: int) -> int:
    """Chunks of output pixels that a general form's weight gradient cuts
    ``pixels`` into, each a row of ``elems`` f32 partials that
    ``pconv_colsum`` adds in order: about sqrt(pixels), so that both chains
    of f32 adds (a chunk's pixels, then the chunks) stay short; at most
    65535 (a grid's y) and at most GEN_PART_FLOATS / elems rows."""
    return max(1, min(math.isqrt(max(pixels - 1, 0)) + 1, 65535,
                      GEN_PART_FLOATS // max(elems, 1)))


def _count(name: str) -> None:
    """Add one to the launch counter ``name``, under a lock: several host
    threads may launch at once, and ``+=`` on a module global is not atomic."""
    with _COUNT_LOCK:
        globals()[name] += 1


def _stream() -> int:
    # Temporaries a wrapper allocates (re-laid weights, bias) are freed when
    # it returns, before the kernel has run. That is safe: the caching
    # allocator hands a freed block only to work queued after this launch
    # on the same stream.
    return torch.cuda.current_stream().cuda_stream


def k1_group_starts(group_sizes: Sequence[int]) -> Tuple[int, ...]:
    """Each mask group's first channel in K1's x, then cin_x: every group
    starts on a multiple of 8 channels, so a 16-byte chunk of x lies in one
    group."""
    return _layer_starts([-(-size // 8) * 8 for size in group_sizes])


def k1_channels(group_sizes: Sequence[int]) -> Tuple[int, int, int]:
    """K1's channel layout of x: (gb, cin_x, cin_p). The groups start as
    ``k1_group_starts`` says: group 1 at ``gb`` (cin_x for one group), x has
    ``cin_x`` channels (a multiple of 8), and the weights' K axis is padded
    to ``cin_p``, a multiple of the 64-channel K step. Equal to the layer's
    own layout when every group size is a multiple of 8, as at every U-Net
    level."""
    starts = k1_group_starts(group_sizes)
    return starts[1], starts[-1], -(-starts[-1] // _BK) * _BK


def _layer_starts(group_sizes: Sequence[int]) -> Tuple[int, ...]:
    """Each group's first channel, then their sum."""
    return tuple(itertools.accumulate(group_sizes, initial=0))


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


def k1_plan(n: int, h: int, w: int, cout: int, cin_p: int, k: int, pad, g: int = 1) -> K1Plan:
    """K1's plan for N images of H x W, Cout output channels, Cin_p
    channels (``k1_channels``), a k x k window and ``pad`` (one padding
    for H and W, or the pair (ph, pw)): a pure function of the shape, the
    same on every call.

    The halo form (``csrc/partial_conv.cu::pconv_k1_halo``) where it
    applies and Cout <= 128: a 3 x 3 window, an output width of 64 or a
    multiple of 128 and Hout * Wout a multiple of 128 (dec2 and dec1 of
    the U-Net, whole or on an H shard); BM 256 for BN 64 where the
    geometry and the grid allow (dec1),
    else 128; only with one or two mask groups (``g``), whose per-pixel
    bits the halo form keeps. Else the plain gather, whose time is the
    operand tiles it moves from L2 into shared memory: the tile (BM x BN) and the number of
    K splits that give the fewest waves x K steps x stage bytes, plus the
    split partials' round trip (``_k1_gather_cost``). A grid of 132 tiles
    or more never splits; a smaller one splits K into ``splits`` CTAs per
    tile, so that the grid holds at least 132 CTAs, each over a nonempty
    contiguous range of K steps (``k1_split_ranges``)."""
    cout_p = -(-cout // 8) * 8
    ph, pw = _pads(pad)
    hout, wout = h + 2 * ph - k + 1, w + 2 * pw - k + 1
    p = n * hout * wout

    def tiles(bm, bn):
        return -(-p // bm) * -(-cout_p // bn)

    def halo_fits(bm):  # each m64 tile in one image row, no tile across two images
        return (k == 3 and wout % 64 == 0 and (wout % bm == 0 or bm % wout == 0)
                and (hout * wout) % bm == 0)

    if cout_p <= 128 and g <= 2 and halo_fits(128):
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
    _, _, cin_p = k1_channels(group_sizes)
    sx, sl = k1_group_starts(group_sizes), _layer_starts(group_sizes)
    cout_p = -(-cout // 8) * 8
    wt = weight.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(kh * kw, cout, cin)
    if (cout_p, cin_p, sx) == (cout, cin, sl):
        return wt.contiguous()
    out = torch.zeros((kh * kw, cout_p, cin_p), dtype=torch.bfloat16, device=weight.device)
    for i, size in enumerate(group_sizes):
        out[:, :cout, sx[i]:sx[i] + size] = wt[..., sl[i]:sl[i] + size]
    return out


def k1_input_relayout(x: torch.Tensor, group_sizes: Sequence[int]) -> torch.Tensor:
    """x as K1 reads it: (N, H, W, cin_x), each group from a multiple of 8
    channels (``k1_channels``), zero between, 16-byte aligned. ``x`` itself
    where it already is (every U-Net level)."""
    sx, sl = k1_group_starts(group_sizes), _layer_starts(group_sizes)
    if sx == sl:
        return x if x.data_ptr() % 16 == 0 else x.clone()
    out = x.new_zeros((*x.shape[:3], sx[-1]))
    for i, size in enumerate(group_sizes):
        out[..., sx[i]:sx[i] + size] = x[..., sl[i]:sl[i] + size]
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
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    n, h, w, cin, g, cout, k, (ph, pw), hout, wout = _check_inputs(x, mask, weight, bias,
                                                                   group_sizes, padding)
    lib = load_library()
    gb, cin_x, cin_p = k1_channels(group_sizes)
    cout_p = -(-cout // 8) * 8
    p = n * hout * wout
    plan = k1_plan(n, h, w, cout, cin_p, k, (ph, pw), g)
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
        n, h, w, cin, g, s0, s1, hout, wout, cout, cin_x, gb, cin_p, cout_p, k, ph, pw,
        plan.splits, plan.bm, plan.bn, int(plan.halo), _groups_ptr(group_sizes, x.device),
        _stream(),
    )
    check(lib, code, "K1 (partial conv, Cout >= 8)")
    _count("K1_LAUNCHES")
    return y, m_out


def f32_weight_relayout(weight: torch.Tensor) -> torch.Tensor:
    """OIHW weights -> K2F's (k*k, Cin, Cout) f32: per tap, a row of Cout
    weights per input channel (the plain version of what
    ``pconv_f32_relay`` writes in K2F's launch)."""
    cout, cin, kh, kw = weight.shape
    return weight.to(torch.float32).permute(2, 3, 1, 0).reshape(kh * kw, cin, cout).contiguous()


def f32_bwd_weight_relayout(weight: torch.Tensor) -> torch.Tensor:
    """OIHW weights -> K2F's backward's (k*k, Cout, Cin) f32 (what
    ``pconv_f32_relay`` writes in its launch)."""
    cout, cin, kh, kw = weight.shape
    return weight.to(torch.float32).permute(2, 3, 0, 1).reshape(kh * kw, cout, cin).contiguous()


# K2F and its backward, as csrc/partial_conv.cu has them
# (tests/test_torch_f32_kernels.py holds the two against each other)
K2F_R = 3  # output pixels a thread owns along a row
K2F_THREADS = 256  # 8 warps, each a slice of the input channels
K2F_TW = 32 * K2F_R  # output columns of a CTA's strip
K2F_RING = 3  # input rows in the ring
K2F_CTAS = 2  # resident CTAs an SM (``__launch_bounds__``)
K2F_KS = (1, 3, 5, 7)  # the windows K2F is built for
K2F_BWD_KS = (1, 3)  # and its backward: from k 5 the general form is the faster (PERF.md)
HB_SEG = 32  # input columns of a backward thread's segment
HB_NSEG = 8  # most segments of a backward strip
HB_THREADS = 256  # most threads of a backward CTA
HB_RING = 3  # x rows in the backward's ring
_SMEM_SM = 233472  # shared memory of an SM, of which each resident CTA also takes 1 KB


def _k2f_stage_floats(pixels: int, cin: int) -> int:
    """Floats of a stage of ``pixels`` input pixels: x's row (a phase of up
    to 3 floats in front, the last 16-byte copy up to 3 past), rounded to
    4, then 2 mask floats a pixel (``k2f_stage_floats``)."""
    return _round_up(_round_up(pixels * cin + 6, 4) + 2 * pixels, 4)


def k2f_smem_bytes(cin: int, cout: int, k: int) -> int:
    """K2F's dynamic shared memory: the ring's stages, the weights as (Cin,
    k*k*Cout padded to 4), the warps' sums of a row and the last k input
    rows' masks (2 floats a pixel) that the window counts read."""
    wpc = _round_up(k * k * cout, 4)
    return 4 * (K2F_RING * _k2f_stage_floats(K2F_TW + k - 1, cin) + cin * wpc
                + 8 * K2F_TW * cout + 2 * k * (K2F_TW + k - 1))


def k2f_bwd_smem_bytes(cin: int, cout: int, k: int, nseg: int) -> int:
    """The backward's: its ring (x rows with masks; HB_RING + k - 1 dacc rows
    of 32 nseg + k - 1 columns, Cout padded to 4), or the segments' dW sums,
    whichever is larger."""
    tw = nseg * HB_SEG
    ring = (HB_RING * _k2f_stage_floats(tw, cin)
            + (HB_RING + k - 1) * (tw + k - 1) * _round_up(cout, 4))
    return 4 * max(ring, nseg * k * k * cout * cin)


def _ctas_an_sm(smem: int) -> int:
    return K2F_CTAS if K2F_CTAS * (smem + 1024) <= _SMEM_SM else 1


@functools.lru_cache(maxsize=256)
def k2f_band_rows(n: int, strips: int, rows: int, halo: int, ctas: int) -> int:
    """Rows of a CTA's band when N images of ``rows`` rows in ``strips``
    strips are cut into bands: the band count whose grid, in waves of
    ``ctas`` CTAs on each of the card's SMs, costs the fewest waves x (band
    rows + ``halo``); the fewest CTAs among equals."""
    best = None
    for bands in range(1, rows + 1):
        rb = -(-rows // bands)
        if -(-rows // rb) != bands:  # the same rb as fewer bands
            continue
        cost = -(-n * strips * bands // (ctas * _SMS)) * (rb + halo)
        if best is None or cost < best[0]:
            best = (cost, rb)
    return best[1]


class K2FPlan(NamedTuple):
    """How K2F or its backward cuts one layer: bands of ``rb`` rows (output
    rows forward, input rows backward) and strips of ``tw`` columns; the
    backward's strips are ``nseg`` segments of HB_SEG columns, one thread
    per (segment, input channel). ``general``: the shape is outside the
    templated form's, and the general form runs it (no bands, no strips:
    those fields are 0)."""

    rb: int
    tw: int
    nseg: int
    threads: int
    general: bool = False

    def grid(self, n: int, rows: int, cols: int) -> int:
        """CTAs of the launch (and the backward's rows of dW partials)."""
        return n * -(-rows // self.rb) * -(-cols // self.tw)


def _k2f_scope(cout: int) -> None:
    if not 1 <= cout <= _K2_MAX_COUT:
        raise ValueError(f"K2F takes Cout 1..{_K2_MAX_COUT}, got Cout {cout}")


# The general forms' geometry, as csrc/partial_conv.cu has it
# (tests/test_torch_scope.py holds the two against each other): a CTA of
# GEN_THREADS threads and a ring of shared rows GEN_D ahead of the rows a
# step reads; the SIMT tile (f32 forward, dx) of GEN_TH rows x GEN_R
# pixels a lane, windows sliding over GEN_L taps, runs of at most GEN_RUN
# taps; the bf16 forward's mma tile of GM_TH rows x GM_NPX input columns,
# GM_MT m16 tiles of (tap, output) rows, runs of at most GM_RUN taps; the
# bf16 dx and dW's blocks of GX_CB channels, dx's runs of at most GX_RUN
# taps, dW's GD_PAIRS tap pairs a CTA; dW's segments of GW_TW columns. A
# forward block takes as many 16-byte units of channels as GEN_SMEM (SIMT)
# or GM_SMEM (mma) hold.
GEN_THREADS = 256
GEN_D = 2
GEN_TH, GEN_R, GEN_L, GEN_RUN = 8, 5, 4, 64
GEN_TW = 32 * GEN_R
GM_TH, GM_NPX, GM_MT, GM_RUN = 4, 64, 3, 16
GM_ZS = GM_NPX + 8
GW_TW = 64
GX_CB, GX_RUN, GD_PAIRS = 80, 16, 8  # the bf16 dx and dW: channels a block, taps a run, pairs
GX_YP = GX_CB + 8
GEN_SMEM = 64 * 1024
GM_SMEM = 100 * 1024
_K2F_GENERAL = K2FPlan(0, 0, 0, GEN_THREADS, True)


class GenPlan(NamedTuple):
    """How the general forms cut one layer (``gen_plan``). Forward: ``cbu``
    16-byte units of channels a block, ``run`` taps a run, ``fwd_smem``
    bytes. dx: ``dx_run`` taps a run, ``dx_smem`` bytes. dW: segments of
    ``rb`` (row, 64-column strip) items, ``segs`` of them (the rows of f32
    partials); a CTA takes ``rg`` runs of ``gen_dw_taps`` taps x ``scg``
    4-channel sub-chunks, each split over ``npg`` pixel groups;
    ``dw_smem`` bytes."""

    cbu: int
    run: int
    fwd_smem: int
    dx_run: int
    dx_smem: int
    rb: int
    segs: int
    rg: int
    scg: int
    npg: int
    dw_smem: int


def gen_dw_taps(cout: int) -> int:
    """Taps of a dW thread's run: its LW x Cout x 4 sums stay within 64."""
    return 8 if cout <= 2 else 4 if cout <= 4 else 2


def gen_fwd_smem(elem: int, cbu: int, run: int, cout: int) -> int:
    """Shared bytes of the forward (``gen_fwd_bf16_smem`` / ``gen_fwd_f32_smem``)."""
    if elem == 2:
        ring = ((GM_TH + GEN_D) * cbu * GM_NPX + (GEN_D + 1) * cbu * GM_MT * 16) * 16
        return max(ring, GM_TH * GM_MT * 16 * GM_ZS * 4)
    return ((GEN_TH + GEN_D) * cbu * (GEN_TW + run) + (GEN_D + 1) * cbu * run * cout) * 16


def gen_dx_smem(elem: int, du: int, run: int, cout: int) -> int:
    """Shared bytes of ``pconv_gen_dx_bf16`` (``gen_dx_bf16_smem``) or
    ``pconv_gen_dx_f32`` (``gen_dx_f32_smem``)."""
    if elem == 2:
        ring = ((GM_TH + GEN_D) * (GM_NPX + run) + (GEN_D + 1) * run * GX_CB) * 16
        return max(ring, GM_TH * GM_NPX * GX_YP * 2)
    return ((GEN_TH + GEN_D) * du * (GEN_TW + run) + (GEN_D + 1) * run * cout * 2) * 16


def gen_dw_smem(elem: int, du: int, cout: int, rg: int, scg: int, npg: int, k: int = 1) -> int:
    """Shared bytes of ``pconv_gen_dw_bf16`` (``gen_dw_bf16_smem``, at ``k``)
    or ``pconv_gen_dw_f32`` (``gen_dw_f32_smem``): its ring of x and dacc
    rows, or the pixel groups' sums, the larger."""
    if elem == 2:
        np_ = min(GD_PAIRS, -(-k // 2))
        ring = (1 + GEN_D) * ((GX_CB // 8) * GW_TW + GW_TW + 2 * GD_PAIRS) * 16
        return max(ring, (GEN_THREADS // 32 // np_ - 1) * np_ * 32 * (GX_CB // 8) * 16)
    lw = gen_dw_taps(cout)
    ring = (1 + GEN_D) * (scg * (GW_TW + 1) + du * (GW_TW + rg * lw)) * 16
    return max(ring, (npg - 1) * rg * scg * lw * cout * 16)


def gen_plan(n: int, h: int, w: int, cin: int, cout: int, k: int, pad, g: int,
             elem: int) -> GenPlan:
    """The general forms' plan for N images of H x W, Cin -> Cout (<= 7), a
    k x k window, ``pad``, ``g`` groups and x's element size (2: bf16, 4:
    f32): a pure function of the shape. Shared memory stays within
    SMEM_LIMIT and the dW partials within GEN_PART_FLOATS (or one row) at
    every k and Cin: runs cap the taps a stage holds, blocks the channels.
    Raises only outside Cout 1..7."""
    _k2f_scope(cout)
    v = 16 // elem
    xu, du = -(-cin // v), -(-cout // v)
    if elem == 2:
        run = min(k, GM_RUN, GM_MT * 16 // cout)
        unit = ((GM_TH + GEN_D) * GM_NPX + (GEN_D + 1) * GM_MT * 16) * 16
        cbu = max(2, min(_round_up(xu, 2), GM_SMEM // unit // 2 * 2))
    else:
        run = min(_round_up(k, GEN_L), GEN_RUN)
        unit = ((GEN_TH + GEN_D) * (GEN_TW + run) + (GEN_D + 1) * run * cout) * 16
        cbu = max(1, min(xu, GEN_SMEM // unit))
    dx_run = min(_round_up(k, 2), GX_RUN) if elem == 2 else min(_round_up(k, GEN_L), GEN_RUN)
    nrw, c4 = -(-k // gen_dw_taps(cout)), -(-cin // 4)
    rg = min(nrw, 64)
    scg = min(c4, 32, GEN_THREADS // rg)
    npg = 1
    while npg < 8 and 2 * npg * rg * scg <= GEN_THREADS:
        npg *= 2
    items = n * h * -(-w // GW_TW)
    most = max(1, GEN_PART_FLOATS // (k * k * cout * cin))
    rb = max(-(-items // most), min(items, 16))
    return GenPlan(cbu, run, gen_fwd_smem(elem, cbu, run, cout), dx_run,
                   gen_dx_smem(elem, du, dx_run, cout), rb, -(-items // rb), rg, scg, npg,
                   gen_dw_smem(elem, du, cout, rg, scg, npg, k))


def k2f_plan(n: int, h: int, w: int, cin: int, cout: int, k: int, pad, g: int = 1) -> K2FPlan:
    """K2F's plan for N images of H x W, Cin -> Cout (<= 7) channels, a k x k
    window, ``pad`` and ``g`` mask groups: strips of K2F_TW output columns,
    bands by ``k2f_band_rows`` (halo k - 1). A pure function of the shape.
    The general form where the templated one does not take it: k not in
    K2F_KS, three or more groups, or a ring that would not fit in shared
    memory (Cin 170 and up at k 3). Raises only outside Cout 1..7."""
    _k2f_scope(cout)
    smem = k2f_smem_bytes(cin, cout, k)
    if k not in K2F_KS or g > 2 or smem > SMEM_LIMIT:
        return _K2F_GENERAL
    ph, pw = _pads(pad)
    hout, wout = h + 2 * ph - k + 1, w + 2 * pw - k + 1
    rb = k2f_band_rows(n, -(-wout // K2F_TW), hout, k - 1, _ctas_an_sm(smem))
    return K2FPlan(rb, K2F_TW, 1, K2F_THREADS)


def k2f_bwd_plan(n: int, h: int, w: int, cin: int, cout: int, k: int, g: int = 1) -> K2FPlan:
    """The backward's plan: as many 32-column segments a strip as
    HB_THREADS threads take at one per (segment, channel), at most
    HB_NSEG; bands of input rows by ``k2f_band_rows``. The general form
    above HB_THREADS input channels, at k not in K2F_BWD_KS, at three or
    more groups, or where shared memory would not hold it."""
    _k2f_scope(cout)
    if k not in K2F_BWD_KS or g > 2 or cin > HB_THREADS:
        return _K2F_GENERAL
    nseg = min(HB_NSEG, HB_THREADS // cin)
    smem = k2f_bwd_smem_bytes(cin, cout, k, nseg)
    if smem > SMEM_LIMIT:
        return _K2F_GENERAL
    tw = nseg * HB_SEG
    rb = k2f_band_rows(n, -(-w // tw), h, k - 1, _ctas_an_sm(smem))
    return K2FPlan(rb, tw, nseg, _round_up(nseg * cin, 32))


# K1F's K step: one tap x K1F_CK input channels (csrc/partial_conv.cu).
K1F_CK = 16
# K1F's CTA tiles (BM output pixels, BN output channels) and the CTAs an
# SM holds of either (``__launch_bounds__(256, K1F_CTAS)``).
K1F_TILES = ((128, 128), (256, 64))
K1F_CTAS = 2


class K1FPlan(NamedTuple):
    """How K1F cuts one layer: the CTA tile (BM pixels x BN channels) and
    the number of K splits."""

    bm: int
    bn: int
    splits: int

    def grid(self, n: int, hout: int, wout: int, cout: int) -> int:
        """CTAs of the GEMM launch: tiles x Cout blocks x splits."""
        return -(-n * hout * wout // self.bm) * -(-cout // self.bn) * self.splits


def k1f_steps(cin: int, k: int) -> int:
    """K1F's K steps of one tile: k*k taps x ceil(Cin / K1F_CK) chunks,
    tap-major (step s is tap s // chunks, chunk s % chunks)."""
    return k * k * -(-cin // K1F_CK)


def k1f_plan(n: int, h: int, w: int, cin: int, cout: int, k: int, pad) -> K1FPlan:
    """K1F's plan for N images of H x W, Cin -> Cout (>= 8) channels, a k x k
    window and ``pad`` (one padding or (ph, pw)): a pure function of the
    shape. BN 64 where Cout <= 64 (BM 256), else 128 (BM 128). A grid of
    ``_SMS`` tiles or more never splits; a smaller one splits K into as many
    contiguous ranges as the card holds CTAs of it (``K1F_CTAS`` an SM),
    and at least enough to reach ``_SMS`` CTAs, never more than the K
    steps (``k1_split_ranges`` gives the ranges)."""
    ph, pw = _pads(pad)
    hout, wout = h + 2 * ph - k + 1, w + 2 * pw - k + 1
    bm, bn = K1F_TILES[1] if cout <= 64 else K1F_TILES[0]
    tiles = K1FPlan(bm, bn, 1).grid(n, hout, wout, cout)
    if tiles >= _SMS:
        return K1FPlan(bm, bn, 1)
    splits = max(-(-_SMS // tiles), K1F_CTAS * _SMS // tiles)
    return K1FPlan(bm, bn, min(k1f_steps(cin, k), splits))


def k1f_weight_relayout(weight: torch.Tensor, bn: int) -> torch.Tensor:
    """OIHW weights -> K1F's (k*k, Cin_p, Cout_p) f32, Cin_p a multiple of
    ``K1F_CK`` and Cout_p of ``bn``, zero in the padding: the plain version
    of what ``pconv_k1f_weights`` (csrc/partial_conv.cu) writes in the
    launch."""
    cout, cin, kh, kw = weight.shape
    cin_p, cout_p = _round_up(cin, K1F_CK), _round_up(cout, bn)
    wt = weight.to(torch.float32).permute(2, 3, 1, 0).reshape(kh * kw, cin, cout)
    if (cin_p, cout_p) == (cin, cout):
        return wt.contiguous()
    out = torch.zeros((kh * kw, cin_p, cout_p), dtype=torch.float32, device=weight.device)
    out[:, :cin, :cout] = wt
    return out


def _launch_f32(x, mask, weight, bias, group_sizes, padding):
    """K1 and K2's f32 form for an f32 x: K1F (``tsii_pconv_k1f``: the
    weights re-laid, x * M with a zero border and zero channels to Cin_p,
    then ``pconv_k1f`` as ``k1f_plan`` says, then the split reduction) at
    Cout >= 8, K2F (``tsii_pconv_k2f``: the weights re-laid, then
    ``pconv_k2f`` as ``k2f_plan`` says, or its general form) at Cout <= 7.
    Both multiply by the mask's value, as the plain version does. Counted
    as K1F or K2F."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    n, h, w, cin, g, cout, k, (ph, pw), hout, wout = _check_inputs(x, mask, weight, bias,
                                                                   group_sizes, padding)
    lib = load_library()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    y = torch.empty((n, hout, wout, cout), dtype=x.dtype, device=x.device)
    m_out = torch.empty((n, hout, wout, 1), dtype=x.dtype, device=x.device)
    s0, s1 = _sizes(group_sizes)
    if cout <= _K2_MAX_COUT:
        plan = k2f_plan(n, h, w, cin, cout, k, (ph, pw), g)
        if plan.general:
            _launch_gen_fwd(lib, x, mask, weight, b, y, m_out, group_sizes, (ph, pw))
            _count("K2F_LAUNCHES")
            return y, m_out
        xk, w32 = _aligned16(x), weight.to(torch.float32).contiguous()
        wk = torch.empty((k * k, cin, cout), dtype=torch.float32, device=x.device)
        code = lib.tsii_pconv_k2f(
            xk.data_ptr(), mask.data_ptr(), w32.data_ptr(), 0 if b is None else b.data_ptr(),
            y.data_ptr(), m_out.data_ptr(), wk.data_ptr(), n, h, w, cin, g, s0, s1, hout, wout,
            cout, k, ph, pw, plan.rb, _stream(),
        )
        check(lib, code, "K2F (the f32 partial conv, Cout <= 7)")
        _count("K2F_LAUNCHES")
        return y, m_out
    plan = k1f_plan(n, h, w, cin, cout, k, (ph, pw))
    f32 = torch.float32
    cin_p, cout_p = _round_up(cin, K1F_CK), _round_up(cout, plan.bn)
    w32 = weight.to(f32).contiguous()
    # re-laid in the launch; the padding, where there is one, stays zero
    padded = (cin_p, cout_p) != (cin, cout)
    wk = (torch.zeros if padded else torch.empty)((k * k, cin_p, cout_p), dtype=f32,
                                                  device=x.device)
    xm = torch.empty((n, h + 2 * ph, w + 2 * pw, cin_p), dtype=f32, device=x.device)
    part = None
    if plan.splits > 1:
        part = torch.empty((plan.splits, n * hout * wout, cout_p), dtype=f32, device=x.device)
    code = lib.tsii_pconv_k1f(
        x.data_ptr(), mask.data_ptr(), w32.data_ptr(), 0 if b is None else b.data_ptr(),
        y.data_ptr(), m_out.data_ptr(), xm.data_ptr(), 0 if part is None else part.data_ptr(),
        wk.data_ptr(), n, h, w, cin, g, s0, s1, hout, wout, cout, k, ph, pw, cin_p, cout_p,
        plan.bm, plan.bn, plan.splits, _groups_ptr(group_sizes, x.device), _stream(),
    )
    check(lib, code, "K1F (the f32 partial conv, Cout >= 8)")
    _count("K1F_LAUNCHES")
    return y, m_out


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class K2Plan(NamedTuple):
    """How K2 and its backward cut one layer: ``nblk`` blocks of ``cb``
    channels (the K of one staged operand, a multiple of 16), and ``kj``,
    the backward's k*k*Cout rows (tap, o) padded to a multiple of 16."""

    cb: int
    nblk: int
    kj: int


def k2_plan(cin: int, cout: int, k: int) -> K2Plan:
    """K2's plan for Cin channels, Cout <= 7 outputs and a k x k window: a
    pure function of the shape. The fewest blocks of at most ``K2_CB_MAX``
    channels, all of one width (the head: 67 -> one block of 80)."""
    nblk = -(-cin // K2_CB_MAX)
    return K2Plan(_round_up(-(-cin // nblk), 16), nblk, _round_up(k * k * cout, 16))


# The routing cut: from this window K2 and its backward run the general
# forms in place of a tile that would fit, because they are the faster on
# the card (tools/gen_forms.py at the head's 67 -> 3 on 8 pages of 512^2;
# PERF.md, Findings). K2F's backward stops at k 3 (K2F_BWD_KS) for the same
# reason; K2F's forward stays templated at every k it takes.
K2_GEN_K = 6


def k2_general(cin: int, cout: int, k: int, g: int = 1, pad=0, backward: bool = False) -> bool:
    """Whether K2 (bf16, Cout <= 7; its backward with ``backward``) runs
    its general form rather than ``pconv_k2<NKB>`` / ``pconv_k2_bwd``: from
    K2_GEN_K, at three or more mask groups, where the tile of ``k2_plan``
    would not fit in shared memory, and in the backward at a padding above
    k - 1. A pure function of the shape."""
    plan = k2_plan(cin, cout, k)
    if k >= K2_GEN_K or (backward and max(_pads(pad)) > k - 1):
        return True
    return g > 2 or k2_smem_bytes(k, plan.cb, plan.kj if backward else 0) > SMEM_LIMIT


def k2_smem_bytes(k: int, cb: int, kj: int = 0) -> int:
    """Dynamic shared memory of K2 (``kj`` 0) or of its backward, in bytes:
    ``k2_fwd_smem`` / ``k2_bwd_smem`` of csrc/partial_conv.cu."""
    a16 = lambda b: _round_up(b, 16)  # noqa: E731
    npx = (K2_TH + k - 1) * (K2_TW + k - 1)  # a tile with its halo
    pix = K2_TH * K2_TW
    slot, row = a16(cb * 2 + 14), (cb + K2_OPAD) * 2
    if kj == 0:  # the slots become the operand rows in place
        return (npx * slot + k * k * K2_NPAD * row + a16(npx * 4) + a16(npx * 8)
                + pix * 4 + pix * K2_NPAD * 2)
    masks = (K2_TH + 2 * k - 2) * (K2_TW + 2 * k - 2) * 8  # the tile and k - 1 around it
    return (pix * slot + pix * row + pix * (kj + K2_OPAD) * 2 + cb * (kj + K2_OPAD) * 2
            + npx * K2_NPAD * 4 + masks + a16(kj * 4) + pix * 4 + pix * 8)


def k2_weight_relayout(weight: torch.Tensor, plan: K2Plan) -> torch.Tensor:
    """OIHW weights -> K2's (nblk, k*k, 8, cb) bf16: per channel block and
    tap, one row of ``cb`` channels per output (the K-major B operand of
    ``mma.sync``), zero in the padding of Cin and Cout."""
    cout, cin, kh, kw = weight.shape
    wp = torch.zeros((K2_NPAD, plan.nblk * plan.cb, kh * kw), dtype=torch.bfloat16,
                     device=weight.device)
    wp[:cout, :cin] = weight.to(torch.bfloat16).reshape(cout, cin, kh * kw)
    return wp.reshape(K2_NPAD, plan.nblk, plan.cb, kh * kw).permute(1, 3, 0, 2).contiguous()


def k2_bwd_weight_relayout(weight: torch.Tensor, plan: K2Plan) -> torch.Tensor:
    """OIHW weights -> the backward's (nblk * cb, kj) bf16: row c, column
    tap * Cout + o, zero in the padding."""
    cout, cin, kh, kw = weight.shape
    wp = torch.zeros((plan.nblk * plan.cb, plan.kj), dtype=torch.bfloat16, device=weight.device)
    wp[:cin, :kh * kw * cout] = weight.to(torch.bfloat16).permute(1, 2, 3, 0).reshape(cin, -1)
    return wp


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_k2(x, mask, weight, bias, group_sizes, padding):
    """K2 (``csrc/partial_conv.cu``: ``pconv_k2``), with the weights
    re-laid in this call (``k2_weight_relayout``), or its general form
    where ``k2_general`` says. Unlike K1 it multiplies by the mask's value,
    so a mask that is not binary gives x * M as the plain version does."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    n, h, w, cin, g, cout, k, (ph, pw), hout, wout = _check_inputs(x, mask, weight, bias,
                                                                   group_sizes, padding)
    lib = load_library()
    plan = k2_plan(cin, cout, k)
    b = None if bias is None else bias.to(x.dtype).float().contiguous()
    y = torch.empty((n, hout, wout, cout), dtype=x.dtype, device=x.device)
    m_out = torch.empty((n, hout, wout, 1), dtype=x.dtype, device=x.device)
    if k2_general(cin, cout, k, g):
        _launch_gen_fwd(lib, x, mask, weight, b, y, m_out, group_sizes, (ph, pw))
        _count("K2_LAUNCHES")
        return y, m_out
    xk, wk = _aligned16(x), k2_weight_relayout(weight, plan)
    s0, s1 = _sizes(group_sizes)
    code = lib.tsii_pconv_k2(
        xk.data_ptr(), mask.data_ptr(), wk.data_ptr(), 0 if b is None else b.data_ptr(),
        y.data_ptr(), m_out.data_ptr(), n, h, w, cin, g, s0, s1, hout, wout, cout, k, ph, pw,
        plan.cb, plan.nblk, _stream(),
    )
    check(lib, code, "K2 (partial conv, Cout <= 7)")
    _count("K2_LAUNCHES")
    return y, m_out


def _check_cotangent(g, x, n, hout, wout, cout):
    if g.shape != (n, hout, wout, cout) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"the cotangent must be ({n}, {hout}, {wout}, {cout}) {x.dtype} on "
                         f"{x.device}, got {tuple(g.shape)} {g.dtype} on {g.device}")
    return g.contiguous()


def _colsum(lib, part: torch.Tensor) -> torch.Tensor:
    """Per-CTA f32 partials (rows, len) -> their sum over the rows, added
    in a fixed order (``pconv_colsum``)."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check

    out = torch.empty((part.shape[1],), dtype=torch.float32, device=part.device)
    code = lib.tsii_pconv_colsum(part.data_ptr(), out.data_ptr(), part.shape[0], part.shape[1],
                                 _stream())
    check(lib, code, "K3 (sum of the per-CTA partials)")
    return out


def _launch_k2_bwd(g, x, mask, weight, bias, group_sizes, padding, needs):
    """The backward at Cout <= 7 (``pconv_k2_bwd``): dx, dW and db in one
    kernel that reads x, g and the mask once and writes dx once; each CTA
    writes its f32 part of dW and db, and ``pconv_colsum`` adds the parts in
    a fixed order, so two launches give the same bits. The general form
    where ``k2_general`` says (``_launch_gen_bwd``)."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    n, h, w, cin, gr, cout, k, (ph, pw), hout, wout = _check_inputs(x, mask, weight, bias,
                                                                    group_sizes, padding)
    g = _check_cotangent(g, x, n, hout, wout, cout)
    if k2_general(cin, cout, k, gr, (ph, pw), backward=True):
        return _launch_gen_bwd(g, x, mask, weight, bias, group_sizes, (ph, pw), needs)
    lib = load_library()
    plan = k2_plan(cin, cout, k)
    need_dx, need_dw, need_db = needs
    xk, wk = _aligned16(x), k2_bwd_weight_relayout(weight, plan)
    tiles = n * -(-max(h, hout) // K2_TH) * -(-max(w, wout) // K2_TW)
    grid = min(tiles, 2 * _SMS)
    cw = plan.nblk * plan.cb
    part = torch.empty((grid, plan.kj * cw + K2_NPAD), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    s0, s1 = _sizes(group_sizes)
    code = lib.tsii_pconv_k2_bwd(
        g.data_ptr(), xk.data_ptr(), mask.data_ptr(), wk.data_ptr(),
        0 if dx is None else dx.data_ptr(), part.data_ptr(), n, h, w, cin, gr, s0, s1, hout, wout,
        cout, k, ph, pw, plan.cb, plan.nblk, plan.kj, grid, int(need_dx), int(need_dw), int(need_db),
        _stream(),
    )
    check(lib, code, "K3 (partial conv backward, Cout <= 7)")
    dw = db = None
    if need_dw or need_db:
        total = _colsum(lib, part)
        if need_dw:  # (kj, cw) rows (tap, o) -> OIHW, rounded once as the plain version rounds it
            dw = total[:plan.kj * cw].reshape(plan.kj, cw)[:k * k * cout, :cin]
            dw = dw.reshape(k, k, cout, cin).permute(2, 3, 0, 1).to(x.dtype).to(weight.dtype)
        if need_db:
            db = total[plan.kj * cw:plan.kj * cw + cout].to(bias.dtype)
    return dx, dw, db


def _launch_k2f_bwd(g, x, mask, weight, bias, group_sizes, padding, needs):
    """The f32 backward at Cout <= 7: ``k3_prep`` writes dacc and db in one
    pass over g; ``tsii_pconv_k2f_bwd`` re-lays the weights and runs
    ``pconv_k2f_bwd`` as ``k2f_bwd_plan`` says: dx = conv_transpose(dacc, W)
    * M, and each CTA's f32 part of dW, which ``pconv_colsum`` adds in a
    fixed order (two launches, the same bits). The general form where
    ``k2f_bwd_plan`` says (``_launch_gen_bwd``), counted alike."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    n, h, w, cin, gr, cout, k, (ph, pw), hout, wout = _check_inputs(x, mask, weight, bias,
                                                                    group_sizes, padding)
    g = _check_cotangent(g, x, n, hout, wout, cout)
    need_dx, need_dw, need_db = needs
    plan = k2f_bwd_plan(n, h, w, cin, cout, k, gr) if need_dx or need_dw else None
    if plan is not None and plan.general:
        out = _launch_gen_bwd(g, x, mask, weight, bias, group_sizes, (ph, pw), needs)
        _count("K3F_HEAD_LAUNCHES")
        return out
    dacc, db = k3_prep(g, mask, cin, group_sizes, k, (ph, pw), need_db)
    db = db.to(bias.dtype) if need_db else None
    if plan is None:
        return None, None, db
    lib = load_library()
    f32 = torch.float32
    xk, w32 = _aligned16(x), weight.to(f32).contiguous()
    wk = torch.empty((k * k, cout, cin), dtype=f32, device=x.device) if need_dx else None
    dx = torch.empty_like(x) if need_dx else None
    part = torch.empty((plan.grid(n, h, w), k * k * cout * cin), dtype=f32, device=x.device) \
        if need_dw else None
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    code = lib.tsii_pconv_k2f_bwd(
        dacc.data_ptr(), xk.data_ptr(), mask.data_ptr(), w32.data_ptr(), ptr(dx), ptr(part),
        ptr(wk), n, h, w, cin, gr, group_sizes[0], hout, wout, cout, k, ph, pw, plan.rb,
        plan.nseg, int(need_dx), int(need_dw), _stream())
    check(lib, code, "K3F (the f32 partial conv backward, Cout <= 7)")
    _count("K3F_HEAD_LAUNCHES")
    dw = None
    if need_dw:
        dw = _colsum(lib, part).reshape(k, k, cout, cin).permute(2, 3, 0, 1).to(weight.dtype)
    return dx, dw, db


def gen_fwd_weights(weight: torch.Tensor, elem: int, run: int) -> torch.Tensor:
    """OIHW weights (in x's dtype) -> the general forward's layout, zero
    past Cin (and past k): for the bf16 form (elem 2) (k, units, k, Cout,
    8) in the weights' dtype, for the f32 form (k, units, runs * run, Cout,
    4) f32 (tap row, 16-byte unit of channels, tap, output, channel)."""
    cout, cin, k, _ = weight.shape
    v = 16 // elem
    xu = -(-cin // v)
    dt = weight.dtype if elem == 2 else torch.float32
    kp = k if elem == 2 else -(-k // run) * run
    wt = weight.to(dt).permute(2, 1, 3, 0)  # (dy, c, dx, o)
    wt = F.pad(wt, (0, 0, 0, kp - k, 0, xu * v - cin))
    return wt.reshape(k, xu, v, kp, cout).permute(0, 1, 3, 4, 2).contiguous()


def gen_dx_weights(weight: torch.Tensor, run: int, elem: int = 4) -> torch.Tensor:
    """OIHW weights (in x's dtype) -> the general dx's layout, tap dx =
    run * run + run - 1 - r at (tap row, block, run * run + r, ...), taps
    reversed within a run, zero past k, Cin and Cout: ``pconv_gen_dx_f32``'s
    (k, ceil(Cin / 8), runs * run, Cout, 8) f32 (..., o, c), or for bf16
    (elem 2) ``pconv_gen_dx_bf16``'s (k, ceil(Cin / GX_CB), runs * run,
    GX_CB, 8) in the weights' dtype (..., c, o)."""
    cout, cin, k, _ = weight.shape
    nrun = -(-k // run)
    if elem == 2:
        ncb = -(-cin // GX_CB)
        wt = weight.permute(2, 1, 3, 0)  # (dy, c, dx, o)
        wt = F.pad(wt, (0, 8 - cout, 0, nrun * run - k, 0, ncb * GX_CB - cin))
        wt = wt.reshape(k, ncb, GX_CB, nrun, run, 8).flip(4)
        return wt.permute(0, 1, 3, 4, 2, 5).reshape(k, ncb, nrun * run, GX_CB, 8).contiguous()
    nct = -(-cin // 8)
    wt = weight.float().permute(2, 1, 3, 0)  # (dy, c, dx, o)
    wt = F.pad(wt, (0, 0, 0, nrun * run - k, 0, nct * 8 - cin))
    wt = wt.reshape(k, nct, 8, nrun, run, cout).flip(4)
    return wt.permute(0, 1, 3, 4, 5, 2).reshape(k, nct, nrun * run, cout, 8).contiguous()


def _launch_gen_fwd(lib, x, mask, weight, b, y, m_out, group_sizes, padding) -> None:
    """The general form of K2 and K2F into ``y`` and ``m_out``:
    ``pconv_gen_relay`` (x * M as 16-byte units), ``pconv_gen_rowsum`` (the
    mask's row sums), then ``pconv_gen_fwd_bf16`` (``mma.sync``) or
    ``pconv_gen_fwd_f32`` (FFMA) as ``gen_plan`` cuts it; ``b`` the f32 bias
    or None. Inputs as ``_check_inputs`` passed them."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check

    n, h, w, cin = x.shape
    cout, _, k, _ = weight.shape
    ph, pw = padding
    hout, wout = y.shape[1:3]
    elem = x.element_size()
    plan = gen_plan(n, h, w, cin, cout, k, padding, len(group_sizes), elem)
    wk = gen_fwd_weights(weight.to(x.dtype), elem, plan.run)
    xm = torch.empty((n * h * -(-cin // (16 // elem)) * w * 16,), dtype=torch.uint8,
                     device=x.device)
    rsum = torch.empty((n, h, wout), dtype=torch.float32, device=x.device)
    code = lib.tsii_pconv_gen_fwd(
        _aligned16(x).data_ptr(), mask.data_ptr(), wk.data_ptr(), 0 if b is None else b.data_ptr(),
        y.data_ptr(), m_out.data_ptr(), _groups_ptr(group_sizes, x.device, always=True),
        xm.data_ptr(), rsum.data_ptr(), n, h, w, cin, len(group_sizes), hout, wout, cout, k, ph,
        pw, int(elem == 4), plan.cbu, plan.run, _stream())
    check(lib, code, "the general form of K2 / K2F (partial conv, Cout <= 7)")
    _count("GEN_LAUNCHES")


def _launch_gen_bwd(g, x, mask, weight, bias, group_sizes, padding, needs):
    """The general form of the backward at Cout <= 7, bf16 or f32:
    ``k3_prep`` writes dacc and db; ``pconv_gen_relay`` lays dacc (and, for
    dW, x * M) out as 16-byte units; ``pconv_gen_dx_bf16`` / ``_f32`` dx =
    conv_transpose(dacc, W) * M (the weights re-laid by ``gen_dx_weights``);
    ``pconv_gen_dw_bf16`` / ``_f32`` each
    segment's (tap, o, c) partials of dW, which ``pconv_colsum`` adds in
    segment order (``gen_plan``). Two launches give the same bits."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    n, h, w, cin = x.shape
    cout, _, k, _ = weight.shape
    hout, wout = g.shape[1:3]
    need_dx, need_dw, need_db = needs
    dacc, db = k3_prep(g, mask, cin, group_sizes, k, padding, need_db)
    db = db.to(bias.dtype) if need_db else None
    if not (need_dx or need_dw):
        return None, None, db
    lib = load_library()
    elem = x.element_size()
    v = 16 // elem
    plan = gen_plan(n, h, w, cin, cout, k, padding, len(group_sizes), elem)
    wk = gen_dx_weights(weight.to(x.dtype), plan.dx_run, elem) if need_dx else None
    dx = torch.empty_like(x) if need_dx else None
    dm = torch.empty((n * hout * -(-cout // v) * wout * 16,), dtype=torch.uint8, device=x.device)
    xm = part = None
    if need_dw:
        xm = torch.empty((n * h * -(-cin // v) * w * 16,), dtype=torch.uint8, device=x.device)
        part = torch.empty((plan.segs, k * k * cout * cin), dtype=torch.float32, device=x.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    code = lib.tsii_pconv_gen_bwd(
        dacc.data_ptr(), _aligned16(x).data_ptr(), mask.data_ptr(), ptr(wk), ptr(dx), ptr(part),
        _groups_ptr(group_sizes, x.device, always=True), ptr(xm), dm.data_ptr(), n, h, w, cin,
        len(group_sizes), hout, wout, cout, k, padding[0], padding[1], int(elem == 4),
        int(need_dx), int(need_dw), plan.dx_run, plan.rb, plan.rg, plan.scg, plan.npg, plan.segs,
        _stream())
    check(lib, code, "the general form of the partial conv backward (Cout <= 7)")
    _count("GEN_BWD_LAUNCHES")
    dw = None
    if need_dw:  # (tap, o, c) -> OIHW, rounded once as the plain version rounds it
        dw = _colsum(lib, part).reshape(k, k, cout, cin).permute(2, 3, 0, 1)
        dw = dw.to(x.dtype).to(weight.dtype)
    return dx, dw, db


def _check_nhwc(name: str, t: torch.Tensor, dtype=None) -> None:
    """A contiguous (N, H, W, C) CUDA tensor of bf16 or f32 (of ``dtype``
    when given)."""
    ok = t.dtype in (torch.bfloat16, torch.float32) and (dtype is None or t.dtype == dtype)
    if not (t.is_cuda and ok and t.dim() == 4 and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous (N, H, W, C) bfloat16 or float32 CUDA "
                         f"tensor{'' if dtype is None else f' of {dtype}'}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def k3_prep(g, mask, cin: int, group_sizes, k: int, pad, need_db: bool = True):
    """K3's first pass (``pconv_k3_prep``) over the cotangent ``g``
    (N, Hout, Wout, Cout) of a layer with ``cin`` input channels and
    padding ``pad`` (one for H and W, or the pair (ph, pw)): returns
    (dacc, db). dacc = g * scale in g's dtype (bf16 or f32) where the window
    has a valid tap, else 0, channels-last as the products read it; db = sum of g over the
    valid windows, (Cout,) f32, the per-CTA parts added in a fixed order
    (None without ``need_db``). The window count is ``window_scan``'s, the
    forward's own, so dacc is nonzero exactly where M' is 1."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    _check_nhwc("g", g)
    _check_nhwc("mask", mask, g.dtype)
    lib = load_library()
    n, h, w, gr = mask.shape
    _, hout, wout, cout = g.shape
    ph, pw = _pads(pad)
    if (gr != len(group_sizes) or sum(group_sizes) != cin
            or (hout, wout) != (h + 2 * ph - k + 1, w + 2 * pw - k + 1)):
        raise ValueError(f"g {tuple(g.shape)} and mask {tuple(mask.shape)} do not fit groups "
                         f"{tuple(group_sizes)} of {cin} channels, k = {k}, padding {pad}")
    s0, s1 = _sizes(group_sizes)
    dacc = torch.empty_like(g)
    grid = min(-(-n * hout * wout // 128), 8 * _SMS)
    part = torch.empty((grid, cout), dtype=torch.float32, device=g.device) if need_db else None
    prep = lib.tsii_pconv_k3_prep_f32 if g.dtype == torch.float32 else lib.tsii_pconv_k3_prep
    code = prep(
        g.data_ptr(), mask.data_ptr(), dacc.data_ptr(), 0 if part is None else part.data_ptr(),
        n, h, w, cin, gr, s0, s1, hout, wout, cout, k, ph, pw, grid, int(need_db),
        _groups_ptr(group_sizes, g.device), _stream(),
    )
    check(lib, code, "K3 (scaled cotangent and db)")
    return dacc, (_colsum(lib, part) if need_db else None)


def k3_mask(src, mask, group_sizes, out=None):
    """src * M for a contiguous (N, H, W, C) bf16 or f32 tensor, the group
    picked by the channel (``pconv_k3_mask``): one read, one write. Into a
    new tensor, or into ``out`` (in place when ``out`` is ``src``)."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    _check_nhwc("src", src)
    _check_nhwc("mask", mask, src.dtype)
    if mask.shape != (*src.shape[:3], len(group_sizes)) or sum(group_sizes) != src.shape[-1]:
        raise ValueError(f"mask {tuple(mask.shape)} and groups {tuple(group_sizes)} do not fit "
                         f"src {tuple(src.shape)}")
    lib = load_library()
    out = torch.empty_like(src) if out is None else out
    _check_nhwc("out", out, src.dtype)
    c = src.shape[-1]
    apply = lib.tsii_pconv_k3_mask_f32 if src.dtype == torch.float32 else lib.tsii_pconv_k3_mask
    code = apply(src.data_ptr(), mask.data_ptr(), out.data_ptr(), src.numel() // c, c,
                 len(group_sizes), group_sizes[0], _groups_ptr(group_sizes, src.device), _stream())
    check(lib, code, "K3 (x * M)")
    return out


@contextlib.contextmanager
def _no_tf32(on: bool):
    """cuDNN without TF32 inside when ``on``, the flag as it was after."""
    prev = torch.backends.cudnn.allow_tf32
    if on:
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _launch_k3(g, x, mask, weight, bias, group_sizes, padding, needs):
    """The backward at Cout >= 8 (and in f32 at every Cout): ``k3_prep``
    writes dacc and db in one pass over g; ``k3_mask`` writes x * M; one
    ``aten::convolution_backward`` computes both products on channels-last
    views of x's dtype (no layout copy); ``k3_mask`` masks dx in place on
    that call's own output. In f32 cuDNN's TF32 is off for that call alone
    (``torch.backends.cudnn.allow_tf32`` is on by default)."""
    n, h, w, cin, gr, cout, k, pad, hout, wout = _check_inputs(x, mask, weight, bias, group_sizes,
                                                               padding)
    g = _check_cotangent(g, x, n, hout, wout, cout)
    need_dx, need_dw, need_db = needs
    dacc, db = k3_prep(g, mask, cin, group_sizes, k, pad, need_db)
    dx = dw = None
    if need_dx or need_dw:
        xin = k3_mask(x, mask, group_sizes) if need_dw else x
        wb = weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
        with _no_tf32(x.dtype == torch.float32):
            dxm, dw, _ = torch.ops.aten.convolution_backward(
                to_nchw(dacc), to_nchw(xin), wb, None, [1, 1], list(pad), [1, 1], False, [0, 0],
                1, [need_dx, need_dw, False])
        if need_dx:
            dx = dxm.permute(0, 2, 3, 1)
            if not dx.is_contiguous():
                dx = dx.contiguous()
            k3_mask(dx, mask, group_sizes, out=dx)
        if need_dw:
            dw = dw.to(weight.dtype)
    return dx, dw, (db.to(bias.dtype) if need_db else None)
