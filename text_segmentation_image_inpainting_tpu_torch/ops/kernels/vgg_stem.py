"""The frozen VGG16 stem's kernels K4 (dx) and K5 (pool), and their plain versions.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/pallas/vgg_stem_bwd.py``
(K4, ``stem_dx_packed``, and the ``vgg_stem_frozen`` custom VJP) and
``ops/pallas/vgg_stem.py`` (K5, ``stem_pool_packed``). The stem is
torchvision VGG16 ``features[0:5]``: conv0 3->64, relu, conv1 64->64,
relu, 2x2 max pool. The CUDA source is ``csrc/vgg_stem.cu``.

``stem_dx`` and ``stem_pool`` take the plain version only for a tensor on
the CPU. On a CUDA tensor they route by dtype: bf16 launches K4 or K5,
float32 their f32 forms K4F or K5F (the same source), anything else
raises; nothing falls back. Each form counts its own launches:
``K4_LAUNCHES`` / ``K5_LAUNCHES`` (bf16), ``K4F_LAUNCHES`` /
``K5F_LAUNCHES`` (f32; K4F is five device kernels, one launch; the
conv1 passes of K4F and K5F are persistent too, on ``stem_f32_grid``
CTAs).

K4 and K5 are persistent: the wrapper launches ``stem_grid`` CTAs, at
most one per SM, and CTA ``b`` walks the 16x16 tiles ``b``, ``b + grid``,
... in the order of ``stem_schedule`` (the kernel's own walk, in Python,
for the CPU tests).

Semantics the kernels and the plain versions share:
  * the pool gradient goes to the FIRST maximum of each 2x2 window, in
    row-major order (torch's ``max_pool2d`` backward and XLA's
    select-and-scatter agree on this);
  * relu passes no gradient at exactly 0 (torch's ``relu`` backward; the
    JAX twin's ``jnp.maximum`` would split it);
  * the stem's weights are frozen: ``vgg_stem_frozen`` refuses weights
    that require grad and returns none for them.

K5 rounds the conv1 output once (f32 sum plus bias), where the plain
version rounds the conv output and then the sum with the bias, as flax
does; so where ``vgg_stem_frozen`` routes a forward through K5 it may
differ from JAX by one bf16 step.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d, to_nchw, to_nhwc

K4_LAUNCHES = 0
K5_LAUNCHES = 0
K4F_LAUNCHES = 0
K5F_LAUNCHES = 0
# Both kernels' tile: 16x16 output pixels (dx for K4, z1 for K5), as
# DX_TH/DX_TW and PL_TH/PL_TW in csrc/vgg_stem.cu.
STEM_TILE = 16


def stem_tiles(m: int, h: int, w: int) -> int:
    """How many 16x16 tiles cover ``m`` pages of ``h`` x ``w`` (partial
    tiles at the bottom and right edge)."""
    return m * -(-h // STEM_TILE) * -(-w // STEM_TILE)


def stem_grid(m: int, h: int, w: int, sms: int) -> int:
    """The persistent grid: one CTA per SM, or one per tile when there
    are fewer tiles than SMs."""
    return min(sms, stem_tiles(m, h, w))


def stem_schedule(m: int, h: int, w: int, sms: int) -> list:
    """Each CTA's tiles in the order it takes them, as (page, first row,
    first column): CTA ``b`` takes tiles ``b, b + grid, ...`` over (page,
    tile row, tile column), column fastest."""
    tx, ty = -(-w // STEM_TILE), -(-h // STEM_TILE)
    grid = stem_grid(m, h, w, sms)
    return [[(t // (tx * ty), t // tx % ty * STEM_TILE, t % tx * STEM_TILE)
             for t in range(b, stem_tiles(m, h, w), grid)] for b in range(grid)]


# K4F/K5F's conv1 passes (``stem_f32_conv1`` in csrc/vgg_stem.cu, as
# ``SfTile``): the output tile (rows, columns) of each mode, and the CTAs
# an SM holds (``SF_CTAS``). The launcher starts ``stem_f32_grid``
# persistent CTAs; CTA b walks tiles b, b + grid, ... as K4/K5 do.
STEM_F32_TILES = {"pool": (16, 16), "grad": (16, 16), "dgrad": (8, 16)}
STEM_F32_CTAS = 2


def stem_f32_tiles(m: int, h: int, w: int, mode: str) -> int:
    """How many of ``mode``'s tiles cover ``m`` pages of ``h`` x ``w``."""
    th, tw = STEM_F32_TILES[mode]
    return m * -(-h // th) * -(-w // tw)


def stem_f32_grid(m: int, h: int, w: int, mode: str, sms: int) -> int:
    """The conv1 pass's persistent grid: ``STEM_F32_CTAS`` CTAs an SM, or
    one per tile when there are fewer tiles."""
    return min(stem_f32_tiles(m, h, w, mode), STEM_F32_CTAS * sms)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, on NHWC ``x`` (flax ``nn.max_pool``)."""
    return to_nhwc(F.max_pool2d(to_nchw(x), 2, 2))


def stem_forward(x, w0, b0, w1, b1, dtype: torch.dtype) -> torch.Tensor:
    """conv0 -> relu -> conv1 -> relu -> pool in ``dtype``, as flax does it:
    input, kernel and bias cast to ``dtype``, bias added after the conv
    output is rounded (counterpart of ``stem_forward_xla``)."""
    y = x.to(dtype)
    for w, b in ((w0, b0), (w1, b1)):
        y = F.relu(conv2d(y, w, b, padding=1))
    return max_pool_2x2(y)


def stem_dx_reference(x, g, w0, b0, w1, b1) -> torch.Tensor:
    """Plain version of K4: autograd of ``stem_forward`` in ``x.dtype``
    with the weights detached. Returns dx in float32."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        out = stem_forward(xr, w0.detach(), b0.detach(), w1.detach(), b1.detach(), x.dtype)
        (dx,) = torch.autograd.grad(out, xr, g.to(out.dtype))
    return dx.float()


def stem_pool_reference(z0, w1, b1) -> torch.Tensor:
    """Plain version of K5: maxpool2(relu(conv1(relu(z0)) + b1)) in
    ``z0.dtype`` (counterpart of JAX ``stem_pool_reference``)."""
    return max_pool_2x2(F.relu(conv2d(F.relu(z0), w1, b1, padding=1)))


def stem_dx(x, g, w0, b0, w1, b1) -> torch.Tensor:
    """dx (M, H, W, 3) f32 of the frozen stem, given its input ``x`` (M, H,
    W, 3), already normalised, in the compute dtype, and the cotangent
    ``g`` (M, H/2, W/2, 64) of its pooled output. K4 on CUDA, the plain
    version on the CPU; on CUDA K4 for bf16, K4F for float32."""
    if x.device.type == "cpu":
        return stem_dx_reference(x, g, w0, b0, w1, b1)
    if x.dtype == torch.float32:
        return _launch_k4f(x, g, w0, b0, w1, b1)
    return _launch_k4(x, g, w0, b0, w1, b1)


def stem_pool(z0, w1, b1) -> torch.Tensor:
    """maxpool2(relu(conv1(relu(z0)) + b1)) of z0 (M, H, W, 64) in
    z0.dtype: on CUDA K5 for bf16, K5F for float32; the plain version on
    the CPU."""
    if z0.device.type == "cpu":
        return stem_pool_reference(z0, w1, b1)
    if z0.dtype == torch.float32:
        return _launch_k5f(z0, w1, b1)
    return _launch_k5(z0, w1, b1)


class _FrozenStem(torch.autograd.Function):
    """Forward: the plain stem (cuDNN). Backward: K4 (the plain version
    on the CPU); no gradient for the weights."""

    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1, dtype):
        ctx.save_for_backward(x, w0, b0, w1, b1)
        ctx.dtype = dtype
        return stem_forward(x, w0, b0, w1, b1, dtype)

    @staticmethod
    def backward(ctx, g):
        x, w0, b0, w1, b1 = ctx.saved_tensors
        dx = stem_dx(x.to(ctx.dtype).contiguous(), g.to(ctx.dtype).contiguous(), w0, b0, w1, b1)
        return dx.to(x.dtype), None, None, None, None, None


def vgg_stem_frozen(x, w0, b0, w1, b1, dtype: torch.dtype) -> torch.Tensor:
    """``features[0:5]`` of a frozen VGG16 on NHWC ``x``.

    Where a gradient is wanted: the plain forward, K4 for dx. Where none
    is (``x`` needs no grad, or grad mode is off, as for the loss's
    ground-truth branch): conv0, then K5 for the rest, so the conv1
    activations never reach device memory. Weights that require grad are
    refused (the backward gives them none)."""
    if any(t.requires_grad for t in (w0, b0, w1, b1)):
        raise ValueError("vgg_stem_frozen takes frozen weights (requires_grad=False): "
                         "its backward computes dx only")
    if not (torch.is_grad_enabled() and x.requires_grad):
        return stem_pool(conv2d(x.to(dtype), w0, b0, padding=1), w1, b1)
    return _FrozenStem.apply(x, w0, b0, w1, b1, dtype)


def _check(name, t, shape, dtype, device):
    if t.shape != shape or t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _check_weights(w1, b1, device, w0=None, b0=None):
    for name, t, shape in (("w0", w0, (64, 3, 3, 3)), ("b0", b0, (64,)),
                           ("w1", w1, (64, 64, 3, 3)), ("b1", b1, (64,))):
        if t is not None and (tuple(t.shape) != shape or t.device != device):
            raise ValueError(f"{name} must be {shape} on {device}, got {tuple(t.shape)} on {t.device}")


def _w0_rows(w0, dtype):
    """OIHW (64, 3, 3, 3) -> (64 out, 27) in ``dtype``, k = (ky*3 + kx)*3 + in."""
    return w0.to(dtype).permute(0, 2, 3, 1).reshape(64, 27).contiguous()


def _w1_taps(w1, dtype):
    """OIHW (64, 64, 3, 3) -> (3, 3, 64 out, 64 in) in ``dtype``: (9 taps, 64 out,
    64 in) as K4/K5 read it."""
    return w1.to(dtype).permute(2, 3, 0, 1).contiguous()


def _bias(b, dtype):
    """The bias as the forward adds it (rounded to ``dtype``), held in f32."""
    return b.to(dtype).float().contiguous()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _sms(t: torch.Tensor) -> int:
    return _sm_count(t.device.index if t.device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _grid(t: torch.Tensor, m: int, h: int, w: int) -> int:
    return stem_grid(m, h, w, _sms(t))


def _launch_k4(x, g, w0, b0, w1, b1):
    global K4_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"K4 takes a bfloat16 CUDA x (K4F float32), got {x.dtype} on {x.device}")
    if x.dim() != 4 or x.shape[-1] != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"x must be (M, H, W, 3) with H and W even, got {tuple(x.shape)}")
    m, h, w, _ = x.shape
    _check("x", x, x.shape, torch.bfloat16, x.device)
    _check("g", g, (m, h // 2, w // 2, 64), torch.bfloat16, x.device)
    _check_weights(w1, b1, x.device, w0, b0)
    lib = load_library()
    bf = torch.bfloat16
    w0t, w1t, b0f, b1f = _w0_rows(w0, bf), _w1_taps(w1, bf), _bias(b0, bf), _bias(b1, bf)
    dx = torch.empty((m, h, w, 3), dtype=torch.float32, device=x.device)
    code = lib.tsii_stem_dx(x.data_ptr(), g.data_ptr(), w0t.data_ptr(), b0f.data_ptr(),
                            w1t.data_ptr(), b1f.data_ptr(), dx.data_ptr(), m, h, w,
                            _grid(x, m, h, w), _stream())
    check(lib, code, "K4 (VGG stem dx)")
    K4_LAUNCHES += 1
    return dx


def _launch_k5(z0, w1, b1):
    global K5_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    if not z0.is_cuda or z0.dtype != torch.bfloat16:
        raise ValueError(f"K5 takes a bfloat16 CUDA z0 (K5F float32), got {z0.dtype} on "
                         f"{z0.device}")
    if z0.dim() != 4 or z0.shape[-1] != 64 or z0.shape[1] % 2 or z0.shape[2] % 2:
        raise ValueError(f"z0 must be (M, H, W, 64) with H and W even, got {tuple(z0.shape)}")
    m, h, w, _ = z0.shape
    _check("z0", z0, z0.shape, torch.bfloat16, z0.device)
    _check_weights(w1, b1, z0.device)
    lib = load_library()
    w1t, b1f = _w1_taps(w1, torch.bfloat16), _bias(b1, torch.bfloat16)
    out = torch.empty((m, h // 2, w // 2, 64), dtype=torch.bfloat16, device=z0.device)
    code = lib.tsii_stem_pool(z0.data_ptr(), w1t.data_ptr(), b1f.data_ptr(), out.data_ptr(),
                              m, h, w, _grid(z0, m, h, w), _stream())
    check(lib, code, "K5 (VGG stem pool)")
    K5_LAUNCHES += 1
    return out


# Floats of the f32 passes' re-laid weights (SF_WBUF in csrc/vgg_stem.cu):
# w1f and w1b (9 x 64 x 64 each), then w0's (64, 27) rows.
STEM_F32_WBUF = 2 * 9 * 64 * 64 + 64 * 27


def _f32_conv1_taps(w1):
    """conv1's weights as K4F/K5F's conv1 kernel reads them, (9 taps, 64 in,
    64 out) f32: the forward (w1f), and its dgrad (w1b): the taps flipped,
    conv1's output channels as the input, which is the (out, in) order K4
    reads. K5F takes w1f alone. The plain version of what
    ``stem_f32_weights`` (csrc/vgg_stem.cu) writes in the launch."""
    taps = _w1_taps(w1, torch.float32).reshape(9, 64, 64)  # (tap, out, in)
    return taps.transpose(1, 2).contiguous(), taps.flip(0).contiguous()


def _check_f32(name, t):
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"{name} takes a float32 CUDA tensor, got {t.dtype} on {t.device}")
    if t.dim() != 4 or t.shape[1] % 2 or t.shape[2] % 2:
        raise ValueError(f"{name}: (M, H, W, C) with H and W even, got {tuple(t.shape)}")


def _launch_k4f(x, g, w0, b0, w1, b1):
    """K4F: K4 in f32 (``tsii_stem_dx_f32``, device kernels in order on the
    current stream: ``stem_f32_weights`` (the re-laid weights),
    ``stem_f32_conv0``, ``stem_f32_conv1`` with the pool
    gradient, its dgrad, and ``stem_f32_dx``, conv0's dgrad over staged
    tiles). Two scratch tensors of f32 planes (M, 64, H, W rounded up to 4)
    hold a0 (then gz0) and gz1 between them."""
    global K4F_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    _check_f32("K4F", x)
    m, h, w, c = x.shape
    if c != 3:
        raise ValueError(f"K4F: x must be (M, H, W, 3), got {tuple(x.shape)}")
    f32 = torch.float32
    _check("x", x, x.shape, f32, x.device)
    _check("g", g, (m, h // 2, w // 2, 64), f32, x.device)
    _check_weights(w1, b1, x.device, w0, b0)
    lib = load_library()
    w0f, w1f, b0f, b1f = (t.to(f32).contiguous() for t in (w0, w1, b0, b1))
    wbuf = torch.empty(STEM_F32_WBUF, dtype=f32, device=x.device)  # re-laid in the launch
    # the passes' own planes, (M, 64, H, W rounded up to 4): sf_pitch
    a0 = torch.empty((m, 64, h, -(-w // 4) * 4), dtype=f32, device=x.device)
    gz1 = torch.empty_like(a0)
    dx = torch.empty((m, h, w, 3), dtype=f32, device=x.device)
    code = lib.tsii_stem_dx_f32(x.data_ptr(), g.data_ptr(), w0f.data_ptr(), b0f.data_ptr(),
                                w1f.data_ptr(), b1f.data_ptr(), wbuf.data_ptr(), a0.data_ptr(),
                                gz1.data_ptr(), dx.data_ptr(), m, h, w, _sms(x), _stream())
    check(lib, code, "K4F (VGG stem dx, f32)")
    K4F_LAUNCHES += 1
    return dx


def _launch_k5f(z0, w1, b1):
    """K5F: K5 in f32 (``tsii_stem_pool_f32``), the pooled output in f32."""
    global K5F_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    _check_f32("K5F", z0)
    m, h, w, c = z0.shape
    if c != 64:
        raise ValueError(f"K5F: z0 must be (M, H, W, 64), got {tuple(z0.shape)}")
    _check("z0", z0, z0.shape, torch.float32, z0.device)
    _check_weights(w1, b1, z0.device)
    lib = load_library()
    f32 = torch.float32
    w1f, b1f = w1.to(f32).contiguous(), b1.to(f32).contiguous()
    wbuf = torch.empty(9 * 64 * 64, dtype=f32, device=z0.device)  # w1f, re-laid in the launch
    out = torch.empty((m, h // 2, w // 2, 64), dtype=f32, device=z0.device)
    code = lib.tsii_stem_pool_f32(z0.data_ptr(), w1f.data_ptr(), b1f.data_ptr(), wbuf.data_ptr(),
                                  out.data_ptr(), m, h, w, _sms(z0), _stream())
    check(lib, code, "K5F (VGG stem pool, f32)")
    K5F_LAUNCHES += 1
    return out
