"""Kernels K1-K5 against their plain versions, on an NVIDIA card.

Marked ``gpu``: without a CUDA device each test skips (decided inside the
fixture, never at import). On the card, where jax is not installed and
so tests/conftest.py cannot load:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py

Shapes are small but cover what the U-Net's shapes do not: G=1, square
k of 1, 3, 5 and 7, Cin not a multiple of 8 (K1's scalar load path), Cout
not a multiple of 8 (its scalar store path), every Cout of K2, bias on
and off. The tolerance is chip_smoke.py's ``check_close``: M' bit-exact,
y exactly 0 in empty windows, elsewhere one bf16 step of |y| plus 1e-3
of max |y|. K3 (the backward), K4 (the VGG stem's dx) and K5 (its pooled
forward) are held to f32 truth no worse than the bf16 plain version, with
the bounds stated at each test; and gradients reach every U-Net parameter
through K1/K2 on the card.
"""

import numpy as np
import pytest
import torch

from chip_smoke import check_close, check_grads, check_stem_dx
from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import partial_conv2d

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, seed, n, h, w, groups, cout, k, bias):
    rng = np.random.default_rng(seed)
    cin = sum(groups)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(np.float32))
    m = (rng.random((n, h, w, len(groups))) < 0.6).astype(np.float32)
    m[0, : k + 1, : k + 1] = 0  # windows with no valid tap
    wt = torch.from_numpy((rng.standard_normal((cout, cin, k, k)) / np.sqrt(k * k * cin))
                          .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)) if bias else None
    to = lambda a: None if a is None else a.to(dev)  # noqa: E731
    return (x.to(dev, torch.bfloat16), torch.from_numpy(m).to(dev, torch.bfloat16),
            to(wt), to(b))


@pytest.mark.parametrize("groups,cout,k,bias", [
    ((64,), 64, 3, False),
    ((32, 32), 128, 3, True),
    ((48, 16), 200, 3, False),   # two Cout tiles, the second partial
    ((5, 14), 24, 3, True),      # Cin 19: scalar loads
    ((16, 8), 12, 5, False),     # Cout 12: scalar stores; k 5
    ((40,), 16, 1, True),        # 1x1
])
def test_k1_matches_plain(cuda, groups, cout, k, bias):
    x, m, w, b = _case(cuda, cout + k, 2, 13, 17, groups, cout, k, bias)
    kw = dict(group_sizes=groups, padding=(k // 2, k // 2))
    before = kpc.K1_LAUNCHES
    got = kpc.partial_conv2d_fused(x, m, w, b, **kw)
    torch.cuda.synchronize()
    assert kpc.K1_LAUNCHES == before + 1
    check_close("K1", got, kpc.partial_conv2d_reference(x, m, w, b, **kw), require_empty=True)


@pytest.mark.parametrize("cout", range(1, 8))
@pytest.mark.parametrize("groups", [(64, 3), (9,)], ids=["G2", "G1"])
def test_k2_matches_plain(cuda, groups, cout):
    x, m, w, b = _case(cuda, cout, 2, 21, 19, groups, cout, 3, True)
    kw = dict(group_sizes=groups, padding=(1, 1))
    before = kpc.K2_LAUNCHES
    got = kpc.partial_conv2d_fused(x, m, w, b, **kw)
    torch.cuda.synchronize()
    assert kpc.K2_LAUNCHES == before + 1
    check_close("K2", got, kpc.partial_conv2d_reference(x, m, w, b, **kw), require_empty=True)


@pytest.mark.parametrize("k", [1, 5, 7])
def test_k2_other_kernel_sizes(cuda, k):
    """k 5 and 7 need more than 48 KB of shared memory (the opt-in path)."""
    x, m, w, b = _case(cuda, 10 + k, 2, 23, 37, (40, 27), 3, k, True)
    kw = dict(group_sizes=(40, 27), padding=(k // 2, k // 2))
    got = kpc.partial_conv2d_fused(x, m, w, b, **kw)
    torch.cuda.synchronize()
    check_close("K2", got, kpc.partial_conv2d_reference(x, m, w, b, **kw), require_empty=True)


def test_routing_on_cuda(cuda):
    """Stride 1 launches a kernel; stride 2 runs the plain cuDNN form."""
    x, m, w, _ = _case(cuda, 0, 1, 16, 16, (8, 8), 16, 3, False)
    k1 = kpc.K1_LAUNCHES
    partial_conv2d(x, m, w, group_sizes=(8, 8), padding=1)
    assert kpc.K1_LAUNCHES == k1 + 1
    partial_conv2d(x, m, w, group_sizes=(8, 8), stride=2, padding=1)
    assert kpc.K1_LAUNCHES == k1 + 1


def test_kernels_refuse_float32(cuda):
    """No silent conversion: the kernels take bf16, and say so."""
    x, m, w, _ = _case(cuda, 1, 1, 8, 8, (16,), 16, 3, False)
    with pytest.raises(ValueError, match="bfloat16"):
        kpc.partial_conv2d_fused(x.float(), m.float(), w, None, group_sizes=(16,), padding=(1, 1))


def test_unet_gradients_reach_every_parameter(cuda):
    """The K1/K2 outputs carry autograd on the card: a loss through a bf16
    U-Net gives every parameter a finite gradient, nonzero in the decoder
    and the head."""
    rng = np.random.default_rng(7)
    model = InpaintUNet(depth=3, dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(7)).to(cuda).train()
    x = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)).to(cuda)
    m = torch.from_numpy((rng.random((2, 32, 32, 1)) > 0.3).astype(np.float32)).to(cuda)
    k1, k2 = kpc.K1_LAUNCHES, kpc.K2_LAUNCHES
    out = model(x * m, m)
    assert (kpc.K1_LAUNCHES - k1, kpc.K2_LAUNCHES - k2) == (2, 1)
    out.float().square().mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if name.startswith(("dec_", "head")):
            assert p.grad.abs().max() > 0, name


@pytest.mark.parametrize("groups,cout,bias", [((32, 16), 16, False), ((24, 3), 3, True)],
                         ids=["K1", "K2"])
def test_k3_backward_matches_plain(cuda, groups, cout, bias):
    """dx, dW, db of the kernel path against autograd of the plain version
    in f32 from the same bf16 values (chip_smoke.check_grads)."""
    x, m, w, b = _case(cuda, 40 + cout, 2, 15, 18, groups, cout, 3, bias)
    g = torch.randn((2, 15, 18, cout), generator=torch.Generator(cuda).manual_seed(3),
                    device=cuda).to(torch.bfloat16)
    check_grads(f"K3 {groups}->{cout}", x, m, w, b, g, dict(group_sizes=groups, padding=(1, 1)))


@pytest.mark.parametrize("m,h,w", [(3, 16, 16), (2, 32, 48), (1, 48, 32), (2, 18, 26)])
def test_k4_matches_plain(cuda, m, h, w):
    """Ragged M, the smallest geometry, non-square pages, and sizes that
    leave partial tiles at the bottom and right edge. Relative L2 only:
    on pages this small the max error is set by a single pool tie."""
    gen = torch.Generator(cuda).manual_seed(h * w + m)
    x = torch.randn((m, h, w, 3), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((m, h // 2, w // 2, 64), generator=gen, device=cuda).to(torch.bfloat16)
    w0 = torch.randn((64, 3, 3, 3), generator=gen, device=cuda) * 0.3
    w1 = torch.randn((64, 64, 3, 3), generator=gen, device=cuda) * 0.06
    b0 = torch.randn((64,), generator=gen, device=cuda) * 0.1
    b1 = torch.randn((64,), generator=gen, device=cuda) * 0.1
    before = kvs.K4_LAUNCHES
    check_stem_dx(f"K4 {m}x{h}x{w}", x, g, w0, b0, w1, b1, compare_max=False)
    assert kvs.K4_LAUNCHES == before + 1


@pytest.mark.parametrize("m,h,w", [(3, 16, 16), (2, 32, 48), (1, 18, 26)])
def test_k5_matches_plain(cuda, m, h, w):
    gen = torch.Generator(cuda).manual_seed(h + w + m)
    z0 = torch.randn((m, h, w, 64), generator=gen, device=cuda).to(torch.bfloat16)
    w1 = torch.randn((64, 64, 3, 3), generator=gen, device=cuda) * 0.06
    b1 = torch.randn((64,), generator=gen, device=cuda) * 0.1
    before = kvs.K5_LAUNCHES
    got = kvs.stem_pool(z0, w1, b1)
    torch.cuda.synchronize()
    assert kvs.K5_LAUNCHES == before + 1
    want = kvs.stem_pool_reference(z0, w1, b1)
    ones = torch.ones_like(want[..., :1])
    check_close("K5", (got, ones), (want, ones))


def test_frozen_stem_backward_runs_k4(cuda):
    gen = torch.Generator(cuda).manual_seed(5)
    x = torch.rand((2, 16, 16, 3), generator=gen, device=cuda, requires_grad=True)
    w0, b0 = torch.randn((64, 3, 3, 3), device=cuda) * 0.3, torch.zeros(64, device=cuda)
    w1, b1 = torch.randn((64, 64, 3, 3), device=cuda) * 0.06, torch.zeros(64, device=cuda)
    before = kvs.K4_LAUNCHES
    kvs.vgg_stem_frozen(x, w0, b0, w1, b1, torch.bfloat16).float().sum().backward()
    assert kvs.K4_LAUNCHES == before + 1
    assert x.grad.dtype == torch.float32 and torch.isfinite(x.grad).all()
    with pytest.raises(ValueError, match="frozen"):
        kvs.vgg_stem_frozen(x, w0.requires_grad_(), b0, w1, b1, torch.bfloat16)
