"""Kernels K1 and K2 against their plain version, on an NVIDIA card.

Marked ``gpu``: without a CUDA device each test skips (decided inside the
fixture, never at import). On the card, where jax is not installed and
so tests/conftest.py cannot load:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py

Shapes are small but cover what the U-Net's shapes do not: G=1, square
k of 1, 3, 5 and 7, Cin not a multiple of 8 (K1's scalar load path), Cout
not a multiple of 8 (its scalar store path), every Cout of K2, bias on
and off. The tolerance is chip_smoke.py's ``check_close``: M' bit-exact,
y exactly 0 in empty windows, elsewhere one bf16 step of |y| plus 1e-3
of max |y|.
"""

import numpy as np
import pytest
import torch

from chip_smoke import check_close
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
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
