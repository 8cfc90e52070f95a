"""The depthwise weight gradient (K6's plain version) and the depthwise
conv Function of the port against the JAX package, on the CPU.

JAX's XLA twin of the Pallas kernel is the stock VJP of
``conv2d(..., groups=C)``; the plain K6 must match it within 1e-5 of
max |ref| (the JAX kernel test's bound, ``tests/test_depthwise_wgrad.py``).
The flag tests restore both packages' ``USE_CUSTOM_WGRAD``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import text_segmentation_image_inpainting_tpu.ops.depthwise as jdw
import text_segmentation_image_inpainting_tpu_torch.ops.depthwise as tdw
from text_segmentation_image_inpainting_tpu.ops.conv import conv2d as jconv2d
from text_segmentation_image_inpainting_tpu.ops.pallas import depthwise_wgrad as jk
from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import MobileNetV2Encoder
from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
from tests.test_torch_bridge import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


@pytest.fixture(autouse=True)
def _restore_flags():
    prev = jdw.USE_CUSTOM_WGRAD, tdw.USE_CUSTOM_WGRAD
    yield
    jdw.USE_CUSTOM_WGRAD, tdw.USE_CUSTOM_WGRAD = prev


def _rel_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _jax_vjp(x, kern, dy, d):
    """dx, dW of JAX's stock depthwise conv (HWIO kernel)."""
    k, c = kern.shape[0], x.shape[-1]
    p = d * (k - 1) // 2
    _, vjp = jax.vjp(lambda a, b: jconv2d(a, b, stride=1, padding=p, dilation=d, groups=c),
                     jnp.asarray(x), jnp.asarray(kern))
    return vjp(jnp.asarray(dy))


@pytest.mark.parametrize("n,h,w,c,k,d", [
    (2, 16, 16, 128, 3, 1),
    (1, 24, 20, 160, 3, 2),   # C not a multiple of 128
    (2, 9, 13, 192, 3, 4),    # odd H x W, d = 4
    (1, 8, 8, 128, 5, 1),     # k = 5
])
def test_plain_wgrad_matches_jax_vjp(n, h, w, c, k, d):
    rng = np.random.default_rng(n * h + c + k + d)
    x, dy = (rng.standard_normal((n, h, w, c)).astype(np.float32) for _ in range(2))
    kern = rng.standard_normal((k, k, 1, c)).astype(np.float32)
    _, want = _jax_vjp(x, kern, dy, d)
    got = kdw.depthwise_wgrad(torch.from_numpy(x), torch.from_numpy(dy), k, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (k, k, 1, c)
    assert _rel_max(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("c,d,k,h,w", [
    (160, 2, 3, 12, 11),
    (128, 1, 3, 9, 10),
    (144, 4, 3, 13, 12),   # d = 4: most taps of the 13x12 map reach the padding
    (128, 1, 5, 8, 9),     # k = 5
])
def test_function_forward_is_conv2d_and_grads_match_jax(c, d, k, h, w):
    """f32: the forward is the plain conv; dx (the library's data gradient
    on channels-last views) equals the flipped-kernel conv and JAX's VJP,
    and dW JAX's, within 1e-5 of max |ref|."""
    tdw.USE_CUSTOM_WGRAD = True  # the Function, dW on K6's plain version
    rng = np.random.default_rng(1 + c + d + k)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    kern = rng.standard_normal((k, k, 1, c)).astype(np.float32)
    dy = rng.standard_normal((2, h, w, c)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    y = tdw.depthwise_conv2d(xt, wt, d)
    p = d * (k - 1) // 2
    assert torch.equal(y, conv2d(xt, wt, padding=p, dilation=d, groups=c))
    y.backward(torch.from_numpy(dy))
    flipped = conv2d(torch.from_numpy(dy), wt.detach().flip((2, 3)), padding=p, dilation=d,
                     groups=c)
    dx, dw = _jax_vjp(x, kern, dy, d)
    assert xt.grad.shape == xt.shape
    assert _rel_max(xt.grad.numpy(), flipped.numpy()) < 1e-5
    assert _rel_max(xt.grad.numpy(), dx) < 1e-5
    assert _rel_max(wt.grad.numpy(), np.asarray(dw).transpose(3, 2, 0, 1)) < 1e-5


@pytest.mark.parametrize("d", [1, 2, 4])
def test_function_dx_in_bf16(d):
    """bf16: dx is the f32 flipped-kernel conv of the same bf16 values,
    rounded once (one bf16 step, 2^-8 relative, plus 1e-5 of max |ref| for
    the order of the sums), and comes back NHWC in x's dtype."""
    tdw.USE_CUSTOM_WGRAD = True  # the Function
    g = torch.Generator().manual_seed(5 + d)
    c, k = 128, 3
    x = torch.randn((2, 11, 9, c), generator=g).to(torch.bfloat16).requires_grad_(True)
    w = (torch.randn((c, 1, k, k), generator=g) * 0.3).to(torch.bfloat16)
    dy = torch.randn((2, 11, 9, c), generator=g).to(torch.bfloat16)
    tdw.depthwise_conv2d(x, w, d).backward(dy)
    want = conv2d(dy.float(), w.float().flip((2, 3)), padding=d, dilation=d, groups=c)
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape
    torch.testing.assert_close(x.grad.float(), want, rtol=2**-8, atol=1e-5 * want.abs().max().item())


def test_dw_is_rounded_once_to_the_weight_dtype():
    """bf16: dW is the f32 sum rounded once (JAX's ``.astype(kernel.dtype)``),
    and a dy with other strides (as autograd may hand it over) changes nothing."""
    tdw.USE_CUSTOM_WGRAD = True  # the Function, dW on K6's plain version
    g = torch.Generator().manual_seed(2)
    c = 128
    x = torch.randn((2, 10, 10, c), generator=g).to(torch.bfloat16)
    w = torch.randn((c, 1, 3, 3), generator=g).to(torch.bfloat16).requires_grad_(True)
    dy_nchw = torch.randn((2, c, 10, 10), generator=g).to(torch.bfloat16)
    dy = dy_nchw.permute(0, 2, 3, 1)  # NHWC view, not contiguous
    assert not dy.is_contiguous()
    tdw.depthwise_conv2d(x, w, 1).backward(dy)
    want = kdw.depthwise_wgrad_reference(x, dy.contiguous(), 3, 1).permute(3, 2, 0, 1)
    assert w.grad.dtype == torch.bfloat16
    assert torch.equal(w.grad, want.to(torch.bfloat16))
    assert torch.equal(kdw.depthwise_wgrad(x, dy, 3, 1), kdw.depthwise_wgrad(x, dy.contiguous(), 3, 1))


def test_tiny_map_off_centre_taps_are_zero():
    """At 4x4 with d = 4 every off-centre tap lies in the padding."""
    g = torch.Generator().manual_seed(3)
    x, dy = torch.randn((2, 4, 4, 128), generator=g), torch.randn((2, 4, 4, 128), generator=g)
    dw = kdw.depthwise_wgrad(x, dy, 3, 4)
    centre = dw[1, 1].clone()
    dw[1, 1] = 0
    assert torch.equal(dw, torch.zeros_like(dw))
    torch.testing.assert_close(centre[0], (x * dy).sum(dim=(0, 1, 2)), rtol=1e-6, atol=1e-6)


def test_encoder_grads_flag_on_equal_flag_off():
    """The JAX test's check (tests/test_depthwise_wgrad.py:74): same
    parameters, same forward, gradients within 2e-5; and the flag really
    routes the 14 stride-1 depthwise convs with C >= 128 through K6's path."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(np.float32))
    enc = MobileNetV2Encoder().eval()
    with torch.no_grad():
        for name, p in enc.named_parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.3))

    calls = []

    def spy(*a, **kw):
        calls.append(a[2])
        return orig(*a, **kw)

    grads, outs = {}, {}
    orig = tdw.depthwise_wgrad
    for flag in (True, False):
        tdw.USE_CUSTOM_WGRAD = flag
        enc.zero_grad()
        tdw.depthwise_wgrad = spy
        try:
            taps = enc(x)
            sum(t.square().sum() for t in taps.values()).backward()
        finally:
            tdw.depthwise_wgrad = orig
        outs[flag] = {k: v.detach() for k, v in taps.items()}
        grads[flag] = {n: p.grad.clone() for n, p in enc.named_parameters()}
        assert len(calls) == (14 if flag else 0)
        calls.clear()
    for k in outs[True]:
        assert torch.equal(outs[True][k], outs[False][k]), k
    worst = max(_rel_max(grads[True][n].numpy(), grads[False][n].numpy()) for n in grads[True])
    assert worst < 2e-5, worst


def test_supports_agrees_with_jax():
    grid = [(f, g, ci, k, s)
            for f in (32, 127, 128, 144, 960)
            for g in (1, f)
            for ci in (f, 64)
            for k in (1, 2, 3, 5)
            for s in (1, 2)]
    jdw.USE_CUSTOM_WGRAD = tdw.USE_CUSTOM_WGRAD = True
    agree = [tdw.supports(*cfg) == jdw.supports(*cfg) for cfg in grid]
    assert all(agree) and any(tdw.supports(*cfg) for cfg in grid)
    tdw.USE_CUSTOM_WGRAD = False
    assert not any(tdw.supports(*cfg) for cfg in grid)
    assert tdw.MIN_CHANNELS == jk._TC


def test_kernel_scope_agrees_with_jax():
    for shape in [(3, 3, 1, 128), (3, 3, 1, 96), (5, 5, 1, 256), (2, 2, 1, 128), (3, 3, 2, 128),
                  (3, 5, 1, 128)]:
        for stride in ((1, 1), (2, 2)):
            for dil in ((1, 1), (2, 2), (1, 2)):
                assert kdw.supported(stride, dil, shape) == jk.supported(stride, dil, shape)


def test_launch_refuses_a_cpu_tensor():
    x = torch.zeros((1, 4, 4, 128))
    with pytest.raises(ValueError, match="CUDA"):
        kdw._launch_k6(x, x, 3, 1)
