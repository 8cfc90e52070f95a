"""The depthwise k x k conv of NHWC activations on CUDA, and its plain version.

Replaces no TPU kernel: the JAX package leaves its depthwise convs to
XLA. The CUDA source is ``csrc/depthwise_conv.cu``: a persistent grid of
CTAs, each walking tiles (an image, a band of output rows, a strip of
columns, a block of 16-byte channel vectors) staged with their halo by
TMA into two shared-memory buffers, each thread summing runs of output
pixels of one channel vector with its taps in f32 registers. The same
kernel with its taps flipped (``flip``) is the stride-1 data gradient
(``ops/depthwise.py``). ``dw_plan`` (pure Python, CPU-tested) chooses the
channel block, the tile and the grid.

``depthwise_conv2d_fused`` launches it on a CUDA bf16 or f32 tensor and
raises on anything else; ``depthwise_conv2d_plain`` is ``F.conv2d`` with
``groups=C`` on channels-last views (cuDNN on the card), the kernel's
yardstick and the route of every tensor ``in_scope`` refuses. Each launch
runs inside the span ``dw.conv`` (``utils/profiling.py``); ``DW_LAUNCHES``
counts them.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv_output_size, to_nchw, to_nhwc
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build
from text_segmentation_image_inpainting_tpu_torch.utils.profiling import span

DW_LAUNCHES = 0

# the windows and strides the kernel is compiled for (csrc/depthwise_conv.cu
# ``launch_t``); every other depthwise conv takes the plain version
KERNEL_SIZES = (3,)
STRIDES = (1, 2)

# the geometry, as csrc/depthwise_conv.cu has it (tests/test_torch_depthwise_conv.py
# holds the two against each other)
DW_THREADS = 256  # NT: threads per CTA
DW_CTAS_PER_SM = 2  # MIN_CTAS: CTAs an SM, the registers capped for it
DW_VEC_BYTES = 16  # VEC_BYTES: bytes of a channel vector
DW_MAX_BOX = 256  # MAX_BOX: most elements of a TMA box along a dimension
DW_BUF_BYTES = 57344  # BUF_BYTES: most bytes of one staged tile
DW_MAX_CV = 8  # MAX_CV: most channel vectors of a tile
# the plan's aim: the most of a tile's channel block past C
DW_CH_WASTE = 1 / 8
DW_CPT = 4  # CPT: channels a thread owns
DW_RUN = 4  # RUN: outputs of a thread's run
# the widest and tallest tile the plan tries (output pixels)
PLAN_MAX_TW, PLAN_MAX_TH = 128, 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pixel_lanes(cv: int, elem: int) -> int:
    """The CTA's threads over a tile's pixels: each pixel takes cv * 16 /
    (4 * elem) threads, ``DW_CPT`` channels each."""
    return DW_THREADS // (cv * DW_VEC_BYTES // (DW_CPT * elem))


class DWPlan(NamedTuple):
    """How the kernel cuts an (N, Ho, Wo, C) output: blocks of ``cv``
    channel vectors, tiles of ``th`` x ``tw`` output pixels whose input
    (``in_rows`` x ``in_cols`` with the halo) is staged whole, ``tiles``
    tiles walked by ``ctas`` persistent CTAs. A thread sums runs of
    ``DW_RUN`` outputs ``ostep`` columns apart, ``q * d`` input columns
    apart (ostep * s = q * d)."""

    cv: int
    th: int
    tw: int
    in_rows: int
    in_cols: int
    ostep: int
    q: int
    cblocks: int
    tiles: int
    ctas: int

    def box_bytes(self) -> int:
        """The bytes of one staged tile, as one TMA box brings them."""
        return self.in_rows * self.in_cols * self.cv * DW_VEC_BYTES

    def smem_bytes(self) -> int:
        """The dynamic shared memory of a CTA: 128 for the alignment and two
        buffers of the box rounded up to 128 bytes."""
        return 128 + 2 * _cdiv(self.box_bytes(), 128) * 128


@functools.lru_cache(maxsize=None)
def dw_plan(n: int, ho: int, wo: int, c: int, k: int, s: int, d: int, elem: int,
            sms: int) -> DWPlan:
    """The cut of an (N, Ho, Wo, C) output of a k x k, stride-s, dilation-d
    depthwise conv in ``elem``-byte elements on ``sms`` SMs. The channel
    block is the widest of 8, 4, 2 and 1 vectors that leaves at most
    ``DW_CH_WASTE`` of the blocks past C: wide blocks make each staged
    pixel and each CTA's share of a written one whole 128-byte lines. Of
    the tile heights and widths (a multiple of the run's span) whose staged
    input fits one buffer and one TMA box, the plan takes the best product
    of how much of the staged input its outputs need (the halo's share),
    how much of the tiles lies inside the output, how evenly the runs share
    the CTA's lanes, and how far the tiles fill ``DW_CTAS_PER_SM`` CTAs an
    SM; ties go to the smaller tile."""
    vec = DW_VEC_BYTES // elem
    if min(n, ho, wo, c, k, d, sms) < 1 or s not in STRIDES or c % vec:
        raise ValueError(f"no depthwise plan for N {n}, {ho}x{wo}, C {c}, k {k}, s {s}, d {d}, "
                         f"{elem}-byte elements")
    v = c // vec
    cv = next(b for b in (8, 4, 2, 1)
              if b <= DW_MAX_CV and (b == 1 or (b <= v and _cdiv(v, b) * b - v <= v * DW_CH_WASTE)))
    cblocks = _cdiv(v, cv)
    pix, lanes = cv * DW_VEC_BYTES, pixel_lanes(cv, elem)
    r = DW_RUN
    g = math.gcd(s, d)
    ostep, q = d // g, s // g
    unit = r * ostep
    slots = DW_CTAS_PER_SM * sms
    best, best_score = None, -1.0
    for tw in range(unit, PLAN_MAX_TW + 1, unit):
        in_cols = (tw - 1) * s + (k - 1) * d + 1
        if in_cols > DW_MAX_BOX or tw - unit >= wo:
            break
        tiles_w = _cdiv(wo, tw)
        for th in range(1, PLAN_MAX_TH + 1):
            in_rows = (th - 1) * s + (k - 1) * d + 1
            if in_rows > DW_MAX_BOX or in_rows * in_cols * pix > DW_BUF_BYTES or th > ho:
                break
            tiles_h = _cdiv(ho, th)
            tiles = n * cblocks * tiles_h * tiles_w
            runs = th * tw // r
            score = (th * s * tw * s / (in_rows * in_cols)
                     * ho * wo / (tiles_h * th * tiles_w * tw)
                     * runs / (_cdiv(runs, lanes) * lanes)
                     * min(1.0, tiles / slots))
            if score > best_score:
                best_score = score
                best = DWPlan(cv, th, tw, in_rows, in_cols, ostep, q, cblocks, tiles,
                              min(tiles, slots))
    if best is None:
        raise ValueError(f"no depthwise tile fits for {ho}x{wo}, C {c}, k {k}, s {s}, d {d}")
    return best


def in_scope(x: torch.Tensor, k: int, stride: int) -> bool:
    """True where the kernel takes a depthwise conv of NHWC ``x``: a CUDA
    bf16 or f32 tensor whose pixels are whole 16-byte vectors, a window
    and a stride it is compiled for."""
    return (x.is_cuda and (x.dtype is torch.bfloat16 or x.dtype is torch.float32)
            and k in KERNEL_SIZES and stride in STRIDES
            and x.shape[-1] * x.element_size() % DW_VEC_BYTES == 0)


def depthwise_conv2d_plain(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                           dilation: int = 1, padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """The depthwise conv of NHWC ``x`` with the (C, 1, k, k) ``weight``
    cast to x's dtype, zero ``padding`` (rows, columns) on both sides:
    ``F.conv2d(groups=C)`` on channels-last views, NHWC out."""
    y = F.conv2d(to_nchw(x), weight.to(x.dtype), None, stride, tuple(padding), dilation,
                 x.shape[-1])
    return to_nhwc(y)


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        _LIB = build.load_library()
    return _LIB


@functools.lru_cache(maxsize=None)
def _geometry(n: int, h: int, w: int, c: int, k: int, s: int, d: int, ph: int, pw: int,
              elem: int, device: int) -> tuple:
    """(output shape, the launcher's arguments from n to pw, those from cv
    to ctas) of one conv on CUDA device ``device``."""
    ho, wo = conv_output_size(h, k, s, ph, d), conv_output_size(w, k, s, pw, d)
    if ho < 1 or wo < 1:
        raise ValueError(f"a {k}x{k} depthwise conv at dilation {d} leaves no output of "
                         f"{h}x{w} with padding ({ph}, {pw})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = dw_plan(n, ho, wo, c, k, s, d, elem, sms)
    return ((n, ho, wo, c), (n, h, w, c, ho, wo, k, s, d, ph, pw, int(elem == 2)),
            (plan.cv, plan.th, plan.tw, plan.ctas))


def depthwise_conv2d_fused(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                           dilation: int = 1, padding: Tuple[int, int] = (0, 0),
                           flip: bool = False) -> torch.Tensor:
    """``depthwise_conv2d_plain`` on the kernel (with ``flip``, the taps
    reversed): x (N, H, W, C) CUDA bf16 or f32, weight (C, 1, k, k) f32 or
    bf16 on the same card, read as cast to x's dtype. Raises on anything
    the kernel does not take."""
    global DW_LAUNCHES
    if not x.is_cuda or x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise ValueError(f"the depthwise kernel takes an (N, H, W, C) bfloat16 or float32 CUDA "
                         f"x, got {x.dtype} {tuple(x.shape)} on {x.device}")
    n, h, w, c = x.shape
    k = weight.shape[-1]
    if (tuple(weight.shape) != (c, 1, k, k) or k not in KERNEL_SIZES
            or weight.dtype not in (torch.float32, torch.bfloat16) or weight.device != x.device
            or stride not in STRIDES or c * x.element_size() % DW_VEC_BYTES):
        raise ValueError(f"the depthwise kernel takes a ({c}, 1, k, k) f32 or bf16 weight on "
                         f"{x.device} with k in {KERNEL_SIZES}, a stride in {STRIDES} and "
                         f"16-byte pixels; got {weight.dtype} {tuple(weight.shape)} on "
                         f"{weight.device}, stride {stride}, C {c} of {x.dtype}")
    x = x.contiguous()
    if x.data_ptr() % DW_VEC_BYTES:  # TMA reads from 16-byte aligned rows
        x = x.clone()
    weight = weight.contiguous()
    dev = x.device.index
    shape, head, tail = _geometry(n, h, w, c, k, stride, dilation, padding[0], padding[1],
                                  x.element_size(), dev)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    lib = _library()
    with span("dw.conv"):
        code = lib.tsii_dw_conv(x.data_ptr(), weight.data_ptr(), y.data_ptr(), *head,
                                int(weight.dtype is torch.bfloat16), int(flip), *tail,
                                torch._C._cuda_getCurrentRawStream(dev))
    if code:
        build.check(lib, code, "dw_conv")
    DW_LAUNCHES += 1
    return y
