"""The frozen VGG16 stem's kernels K4 (dx) and K5 (pool), and their plain versions.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/pallas/vgg_stem_bwd.py``
(K4, ``stem_dx_packed``, and the ``vgg_stem_frozen`` custom VJP) and
``ops/pallas/vgg_stem.py`` (K5, ``stem_pool_packed``). The stem is
torchvision VGG16 ``features[0:5]``: conv0 3->64, relu, conv1 64->64,
relu, 2x2 max pool. The CUDA source is ``csrc/vgg_stem.cu``.

``stem_dx`` and ``stem_pool`` take the plain version only for a tensor on
the CPU. On a CUDA tensor they launch K4 or K5, or raise; nothing falls
back. ``K4_LAUNCHES`` / ``K5_LAUNCHES`` count the launches.

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

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d, to_nchw, to_nhwc

K4_LAUNCHES = 0
K5_LAUNCHES = 0


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
    version on the CPU."""
    if x.device.type == "cpu":
        return stem_dx_reference(x, g, w0, b0, w1, b1)
    return _launch_k4(x, g, w0, b0, w1, b1)


def stem_pool(z0, w1, b1) -> torch.Tensor:
    """maxpool2(relu(conv1(relu(z0)) + b1)) of z0 (M, H, W, 64): K5 on
    CUDA, the plain version on the CPU."""
    if z0.device.type == "cpu":
        return stem_pool_reference(z0, w1, b1)
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


def _w1_taps(w1):
    """OIHW (64, 64, 3, 3) -> (9 taps, 64 out, 64 in) bf16, as K4/K5 read it."""
    return w1.to(torch.bfloat16).permute(2, 3, 0, 1).contiguous()


def _bias(b):
    """The bias as the forward adds it (rounded to bf16), held in f32."""
    return b.to(torch.bfloat16).float().contiguous()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_k4(x, g, w0, b0, w1, b1):
    global K4_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"K4 takes a bfloat16 CUDA x, got {x.dtype} on {x.device}")
    if x.dim() != 4 or x.shape[-1] != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"x must be (M, H, W, 3) with H and W even, got {tuple(x.shape)}")
    m, h, w, _ = x.shape
    _check("x", x, x.shape, torch.bfloat16, x.device)
    _check("g", g, (m, h // 2, w // 2, 64), torch.bfloat16, x.device)
    _check_weights(w1, b1, x.device, w0, b0)
    lib = load_library()
    # OIHW (64, 3, 3, 3) -> (64 out, 27) bf16, k = (ky*3 + kx)*3 + in
    w0t = w0.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(64, 27).contiguous()
    w1t, b0f, b1f = _w1_taps(w1), _bias(b0), _bias(b1)
    dx = torch.empty((m, h, w, 3), dtype=torch.float32, device=x.device)
    code = lib.tsii_stem_dx(x.data_ptr(), g.data_ptr(), w0t.data_ptr(), b0f.data_ptr(),
                            w1t.data_ptr(), b1f.data_ptr(), dx.data_ptr(), m, h, w, _stream())
    check(lib, code, "K4 (VGG stem dx)")
    K4_LAUNCHES += 1
    return dx


def _launch_k5(z0, w1, b1):
    global K5_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    if not z0.is_cuda or z0.dtype != torch.bfloat16:
        raise ValueError(f"K5 takes a bfloat16 CUDA z0, got {z0.dtype} on {z0.device}")
    if z0.dim() != 4 or z0.shape[-1] != 64 or z0.shape[1] % 2 or z0.shape[2] % 2:
        raise ValueError(f"z0 must be (M, H, W, 64) with H and W even, got {tuple(z0.shape)}")
    m, h, w, _ = z0.shape
    _check("z0", z0, z0.shape, torch.bfloat16, z0.device)
    _check_weights(w1, b1, z0.device)
    lib = load_library()
    w1t, b1f = _w1_taps(w1), _bias(b1)
    out = torch.empty((m, h // 2, w // 2, 64), dtype=torch.bfloat16, device=z0.device)
    code = lib.tsii_stem_pool(z0.data_ptr(), w1t.data_ptr(), b1f.data_ptr(), out.data_ptr(),
                              m, h, w, _stream())
    check(lib, code, "K5 (VGG stem pool)")
    K5_LAUNCHES += 1
    return out
