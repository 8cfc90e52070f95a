"""Kernels K1-K6 against their plain versions, on an NVIDIA card.

Marked ``gpu``: without a CUDA device each test skips (decided inside the
fixture, never at import). On the card, where jax is not installed and
so tests/conftest.py cannot load:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py

Shapes are small but cover what the U-Net's shapes do not: G=1, square
k of 1, 3, 5 and 7, Cin and group sizes not a multiple of 8 (K1's
re-laid x), Cout not a multiple of 8, every Cout of K2, bias on and off;
K1 also at its split-K shapes, on an all-hole page and twice on the same
inputs (bit-identical); K2 also over two channel blocks, with a mask
that is not binary and with a non-finite x in a hole; both also without
padding and with padding 2. The tolerance is chip_smoke.py's
``check_close``: M' bit-exact, y exactly 0 in empty windows, elsewhere
one bf16 step of |y| plus 1e-3 of max |y|. K3's own kernels
(``pconv_k3_prep``, ``pconv_k3_mask``, ``pconv_k2_bwd``) are held bit for
bit to the tensor operations they replace where these round at the same
places. K3 (the backward), K4 (the VGG stem's dx) and K5 (its pooled
forward) are held to f32 truth no worse than the bf16 plain version, with
the bounds stated at each test, K4 and K5 also with more tiles than SMs,
fewer, and a partial last wave of their persistent CTAs, each launched
twice (bit-identical); and gradients reach every U-Net parameter
through K1/K2 on the card. K6 (the depthwise weight gradient) and its
plain version are held to the f64 truth within 1e-5 of Σ|x·dy| per
(tap, channel), K6 launched twice and bit-identical (chip_smoke.py's
``check_wgrad``), at ``K6_RAGGED`` (C off 16 bytes, k 1/5/7, f32, a
partial last wave, column strips); its workspace is shared by calls of
other shapes without changing a bit, and its result permutes to the
weight's (C, 1, k, k) layout without a copy; K6 also at an Xception
shape (C 728, whose 64-byte channel blocks end 24 channels into the
last). The page server on the card (prefetcher stream, pinned result
copies, depth 2 and chunk 2) returns ``run``'s bytes exactly, with K1/K2
launched once per ``run``. An inpaint step captured as a CUDA graph
(``train/multistep.py``) replays bit-equal to the same steps run eagerly,
its learning rate following the warm-up schedule across the replays.
K1 and K2 with unequal H and W padding ((0, 1) and (1, 0), chip_smoke.py's
``PAD_EXTRA``) are reached through ``partial_conv2d`` (a kernel launches,
nothing raises) and held to the plain version, twice bit-identical, their
backward by ``check_grads``; both also at the halo-ed shapes of the U-Net
on a 2048^2 page in 4 bands (``SHARD_SHAPES``, padding (0, 1)). The
multi-device serving paths run on the card with every entry on one card:
the H-sharded U-Net (K1/K2 per band, close to the unsharded forward), the
two-stage pipeline and the data-parallel server (bit-equal to ``run``).
The f32 form of K1/K2 and of the backward (an f32 x) against the plain
version in f64, f16 refused, and an index-less ``"cuda"`` mesh entry that
shares the module instead of copying it. K1F (the f32 form at Cout >= 8)
also at its split-K levels, Cin off its K step, Cout off its tiles, one
image and padding (0, 1), its weights re-laid bit for bit as the plain
re-lay does. K2F (the f32 form at Cout <= 7) and its backward at ragged
shapes (``K2F_CASES``: W off the strips, H shorter than the ring, one
image, Cin 67 and Cin < 4, Cout 1 and 7, k 1, 3, 5), the backward for each
``needs`` subset, twice bit-identical, within 1e-5 relative L2 of f64
autograd, their weights re-laid as the plain re-lays do. The f32 stem
(K4F, K5F) against the plain versions in f64, twice bit-identical, at
``STEM_EXTRA`` and a partial last wave of its persistent conv1 passes,
its weights re-laid as the plain re-lay does, routed by
``vgg_stem_frozen`` in f32; and the whole pipeline over 2 bands
of one card (``spatial_pipeline_run``: K1/K2 per band, the page untouched
outside the text, the masks and clean pages close to ``run``'s). The
kernels at shapes of JAX's Pallas scope that no model reaches
(chip_smoke.py's ``SCOPE_CASES``: Cin 200 and 300, k 2, 9, 11 and 13,
padding above k - 1, three mask groups) in bf16 and f32 through
``partial_conv2d``, their templated or general forms, against the f64
truth, twice bit-identical, the backward by ``check_grads`` /
``check_grads_f32``; K6's general form at ``SCOPE_K6`` (k 9, and k 7 at
d 48) by ``check_wgrad``; and an output height of 12 on the plain route.
The depthwise kernel (``csrc/depthwise_conv.cu``) at every depthwise conv
of the benchmark's cells (chip_smoke.py's ``DW_SHAPES``, 2 pages) and at
``DW_RAGGED`` (odd maps, one channel vector, stride 2 at dilations 2 and
3, a band's padding, a partial last wave), forward and flipped dx in bf16
and f32, by ``check_dw`` (the f64 truth within one rounding to the dtype
plus the f32 sum's order; twice bit-identical); routed by what the input
shows, a misaligned x copied, and the Function's dx the kernel's.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    DW_SHAPES,
    K1_EXTRA,
    K6_RAGGED,
    PAD_EXTRA,
    SCOPE_CASES,
    SCOPE_K6,
    SHARD_SHAPES,
    STEM_EXTRA,
    check_close,
    check_dw,
    check_f32,
    check_grads,
    check_grads_f32,
    check_stem_dx,
    check_stem_dx_repeats,
    check_stem_f32,
    check_stem_pool,
    check_wgrad,
    launch_counters,
    scope_case_inputs,
    state_snapshot,
    stem_weights,
)
from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet
from text_segmentation_image_inpainting_tpu_torch.ops import depthwise
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import (
    apply_mask,
    in_kernel_scope,
    mask_window_sum,
    partial_conv2d,
)

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
    ((5, 14), 24, 3, True),      # Cin 19: groups off the 8-channel chunk (re-laid x)
    ((16, 8), 12, 5, False),     # Cout 12: off the 8-channel tile; k 5
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


@pytest.mark.parametrize("name,n,h,w,groups,cout", [
    ("dec7 4x4, split K", 8, 4, 4, (512, 512), 512),
    ("dec6 8x8, split K", 8, 8, 8, (512, 512), 512),
    *K1_EXTRA,
])
def test_k1_v2_matches_plain(cuda, name, n, h, w, groups, cout):
    """K1 at its split-K shapes (the decoder's two deepest levels), at a
    ragged shape (groups off the 8-channel chunk, Cin off the 64-channel
    K step, Cout off every tile, P off the 128-pixel tile), with one mask
    group, and in the halo form at both tile widths."""
    x, m, wt, b = _case(cuda, n * h, n, h, w, groups, cout, 3, False)
    kw = dict(group_sizes=groups, padding=(1, 1))
    got = kpc.partial_conv2d_fused(x, m, wt, b, **kw)
    torch.cuda.synchronize()
    check_close(name, got, kpc.partial_conv2d_reference(x, m, wt, b, **kw), require_empty=True)


def test_k1_all_hole_page_is_exactly_zero(cuda):
    x, m, w, b = _case(cuda, 3, 2, 16, 16, (64, 64), 128, 3, True)
    m = torch.zeros_like(m)
    x[0, 0, 0, 0] = float("inf")  # a hole's value never reaches the sum
    y, m_out = kpc.partial_conv2d_fused(x, m, w, b, group_sizes=(64, 64), padding=(1, 1))
    torch.cuda.synchronize()
    assert (y == 0).all() and (m_out == 0).all()


@pytest.mark.parametrize("h,cout", [(4, 512), (64, 256), (64, 64)],
                         ids=["split K", "one pass", "halo form"])
def test_k1_launches_are_bit_identical(cuda, h, cout):
    """No atomics: the split-K partials are added in a fixed order."""
    x, m, w, _ = _case(cuda, h, 8, h, h, (256, 256), cout, 3, False)
    kw = dict(group_sizes=(256, 256), padding=(1, 1))
    y1, m1 = kpc.partial_conv2d_fused(x, m, w, None, **kw)
    y2, m2 = kpc.partial_conv2d_fused(x, m, w, None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(m1, m2)


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


def test_k2_over_two_channel_blocks(cuda):
    """Cin 130 is two blocks of 80 channels, the second partly padding."""
    x, m, w, b = _case(cuda, 5, 2, 21, 19, (100, 30), 3, 3, True)
    assert kpc.k2_plan(130, 3, 3).nblk == 2
    kw = dict(group_sizes=(100, 30), padding=(1, 1))
    got = kpc.partial_conv2d_fused(x, m, w, b, **kw)
    torch.cuda.synchronize()
    check_close("K2", got, kpc.partial_conv2d_reference(x, m, w, b, **kw), require_empty=True)


def test_k2_multiplies_by_the_mask_value_and_skips_holes(cuda):
    """K2 keeps x * M for a mask that is not binary, a hole's x (here
    infinite and NaN) never reaches the sum, and two launches agree bit
    for bit."""
    x, m, w, b = _case(cuda, 6, 2, 21, 19, (64, 3), 3, 3, True)
    kw = dict(group_sizes=(64, 3), padding=(1, 1))
    soft = m * 0.5
    got = kpc.partial_conv2d_fused(x, soft, w, b, **kw)
    check_close("K2 soft", got, kpc.partial_conv2d_reference(x, soft, w, b, **kw),
                require_empty=True)
    xi = x.clone()
    xi[0, 0, 0, 0], xi[0, 1, 1, 65] = float("inf"), float("nan")
    assert m[0, 0, 0, 0] == 0 and m[0, 1, 1, 1] == 0
    first = kpc.partial_conv2d_fused(xi, m, w, b, **kw)
    again = kpc.partial_conv2d_fused(xi, m, w, b, **kw)
    torch.cuda.synchronize()
    check_close("K2 inf", first, kpc.partial_conv2d_reference(x, m, w, b, **kw),
                require_empty=True)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_routing_on_cuda(cuda):
    """Stride 1 launches a kernel; stride 2 runs the plain cuDNN form."""
    x, m, w, _ = _case(cuda, 0, 1, 16, 16, (8, 8), 16, 3, False)
    k1 = kpc.K1_LAUNCHES
    partial_conv2d(x, m, w, group_sizes=(8, 8), padding=1)
    assert kpc.K1_LAUNCHES == k1 + 1
    partial_conv2d(x, m, w, group_sizes=(8, 8), stride=2, padding=1)
    assert kpc.K1_LAUNCHES == k1 + 1


@pytest.mark.parametrize("groups,cout,k,bias,pad", [
    ((64,), 64, 3, False, (1, 1)),
    ((48, 16), 200, 3, True, (1, 1)),   # two Cout tiles of 64 and a partial one
    ((5, 14), 24, 5, True, (2, 2)),     # groups off any alignment; k 5
    ((16, 8), 12, 3, False, (0, 1)),    # an H-sharded layer's padding
    ((64, 3), 3, 3, True, (1, 1)),      # the RGB head: K2's scope
    ((6, 13), 5, 5, True, (1, 2)),      # Cout 5, k 5, unequal padding
    ((40,), 7, 1, False, (0, 0)),       # 1x1, Cout 7
])
def test_kernels_take_float32(cuda, groups, cout, k, bias, pad):
    """An f32 x runs the f32 form (K1F at Cout >= 8, K2F at Cout <= 7, K3F
    for the backward), as JAX's Pallas kernels take x's dtype: against the
    plain version in f64, M' bit-exact, y within 1e-5 (|y| + max |y|), the
    gradients within 1e-5 relative L2 of f64 autograd; twice bit-identical."""
    x, m, w, b = _case(cuda, 21, 2, 13, 11, groups, cout, k, bias)
    x, m = x.float(), m.float()
    kw = dict(group_sizes=groups, padding=pad)
    name = "K2F_LAUNCHES" if cout <= 7 else "K1F_LAUNCHES"
    before = {c: getattr(kpc, c) for c in ("K1_LAUNCHES", "K2_LAUNCHES", name, "K3F_LAUNCHES")}
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b) if t is not None]
    y, nm = kpc.partial_conv2d_fused(leaves[0], m, leaves[1], leaves[2] if bias else None, **kw)
    y2, nm2 = kpc.partial_conv2d_fused(x, m, w, b, **kw)
    assert y.dtype == torch.float32 and torch.equal(y, y2) and torch.equal(nm, nm2)
    ref = [t.detach().double().requires_grad_(True) for t in leaves]
    y_ref, m_ref = kpc.partial_conv2d_reference(ref[0], m.double(), ref[1],
                                                ref[2] if bias else None, **kw)
    assert torch.equal(nm.double(), m_ref)
    err = (y.double() - y_ref).abs()
    assert (err <= 1e-5 * (y_ref.abs() + y_ref.abs().max())).all(), err.max().item()
    g = torch.randn(y.shape, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    got = torch.autograd.grad(y, leaves, g)
    want = torch.autograd.grad(y_ref, ref, g.double())
    for what, a, r in zip(("dx", "dW", "db"), got, want):
        assert a.dtype == torch.float32, what
        rel = ((a.double() - r).norm() / r.norm().clamp_min(1e-30)).item()
        assert rel < 1e-5, (what, rel)
    assert {c: getattr(kpc, c) - v for c, v in before.items()} == {
        "K1_LAUNCHES": 0, "K2_LAUNCHES": 0, name: 2, "K3F_LAUNCHES": 1}


def test_kernels_refuse_float16(cuda):
    """No silent conversion: the kernels take bf16 or f32, and say so."""
    x, m, w, _ = _case(cuda, 1, 1, 8, 8, (16,), 16, 3, False)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        kpc.partial_conv2d_fused(x.half(), m.half(), w, None, group_sizes=(16,), padding=(1, 1))


def test_replicate_keeps_the_module_on_an_index_less_cuda_entry(cuda):
    """A mesh entry "cuda" is the current device: one device, and the
    module itself where its parameters already live (no copy)."""
    from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import (
        distinct_devices,
        make_mesh,
        replicate,
    )

    model = torch.nn.Linear(4, 4).to(cuda)
    mesh = make_mesh(devices=["cuda", "cuda:0" if torch.cuda.current_device() == 0 else "cuda"])
    assert distinct_devices(mesh) == [torch.device("cuda", torch.cuda.current_device())]
    assert all(replicate(model, d) is model for d in mesh.device_list)
    assert replicate(model, "cuda") is model


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


def _cotangent(dev, shape, seed=3):
    return torch.randn(shape, generator=torch.Generator(dev).manual_seed(seed),
                       device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("groups,cout,k", [((32, 16), 16, 3), ((5, 14), 24, 3), ((7, 5), 12, 5),
                                           ((40,), 300, 1)],
                         ids=["16B", "16B-odd-groups", "scalar-k5", "G1-k1-two-chunk-rows"])
def test_k3_prep_matches_plain(cuda, groups, cout, k):
    """dacc bit for bit (one f32 product, rounded once, on both sides), db
    up to the order of an f32 sum, and dacc nonzero exactly where the
    forward's M' is 1."""
    x, m, w, _ = _case(cuda, 60 + cout, 2, 13, 17, groups, cout, k, False)
    g = _cotangent(cuda, (2, 13, 17, cout)).abs() + 0.5
    cin, pad = sum(groups), k // 2
    dacc, db = kpc.k3_prep(g, m, cin, groups, k, pad)
    torch.cuda.synchronize()
    msum = mask_window_sum(m, groups, (k, k), stride=(1, 1), padding=(pad, pad))
    valid = msum > 0
    # a true f32 division, as the kernel's and JAX's (``scalar / tensor`` in
    # torch is a reciprocal and a product: one more rounding)
    scale = torch.where(valid, torch.full_like(msum, k * k * cin) / torch.clamp(msum, min=1.0), 0.0)
    assert torch.equal(dacc, (g.float() * scale).to(torch.bfloat16))
    want = (g.float() * valid).sum(dim=(0, 1, 2))
    torch.testing.assert_close(db, want, rtol=1e-5, atol=0)
    _, m_out = kpc.partial_conv2d_fused(x, m, w, None, group_sizes=groups, padding=(pad, pad))
    assert torch.equal(dacc[..., :1] != 0, m_out != 0) and int((m_out == 0).sum()) > 0
    again = kpc.k3_prep(g, m, cin, groups, k, pad)
    assert torch.equal(dacc, again[0]) and torch.equal(db, again[1])
    assert kpc.k3_prep(g, m, cin, groups, k, pad, need_db=False)[1] is None


@pytest.mark.parametrize("groups", [(64, 3), (12, 12), (16,), (5, 14)],
                         ids=["scalar-67", "16B-boundary-off-8", "G1", "scalar-19"])
def test_k3_mask_matches_plain(cuda, groups):
    """x * M with the group picked by the channel, also where a 16-byte
    chunk straddles the two groups; out of place and in place."""
    x, m, _, _ = _case(cuda, 70 + len(groups), 2, 13, 17, groups, 8, 3, False)
    want = apply_mask(x, m, groups)
    assert torch.equal(kpc.k3_mask(x, m, groups), want)
    y = x.clone()
    assert kpc.k3_mask(y, m, groups, out=y) is y and torch.equal(y, want)


@pytest.mark.parametrize("groups,cout,k,bias", [((64, 3), 3, 3, True), ((9,), 5, 3, False),
                                               ((100, 30), 2, 3, True), ((24, 3), 3, 5, True),
                                               ((20,), 7, 1, True)],
                         ids=["head", "G1", "two-blocks", "k5-three-passes", "k1"])
def test_k2_bwd_matches_plain(cuda, groups, cout, k, bias):
    """``pconv_k2_bwd`` (dx, dW, db in one kernel) by chip_smoke's
    ``check_grads``; then on the same inputs against K3's plain version in
    bf16, dx within one bf16 step, twice, bit-identical."""
    x, m, w, b = _case(cuda, 80 + cout, 2, 21, 19, groups, cout, k, bias)
    g = _cotangent(cuda, (2, 21, 19, cout))
    kw = dict(group_sizes=groups, padding=(k // 2, k // 2))
    check_grads(f"K3 {groups}->{cout}", x, m, w, b, g, kw)
    wb, bb = w.to(torch.bfloat16), None if b is None else b.to(torch.bfloat16)
    args = (g, x, m, wb, bb, groups, (k // 2, k // 2))
    before = kpc.K3_LAUNCHES
    first, again = kpc.partial_conv2d_backward(*args), kpc.partial_conv2d_backward(*args)
    torch.cuda.synchronize()
    assert kpc.K3_LAUNCHES == before + 2
    want = kpc.partial_conv2d_backward_reference(*args)
    for a, a2, r in zip(first, again, want):
        assert (a is None) == (r is None)
        if a is not None:
            assert torch.equal(a, a2) and a.dtype == r.dtype and a.shape == r.shape
            top = r.float().abs().max().item()
            torch.testing.assert_close(a.float(), r.float(), rtol=2**-7, atol=2e-3 * top)
    only_dw = kpc.partial_conv2d_backward(*args, needs=(False, True, False))
    assert only_dw[0] is None and only_dw[2] is None and torch.equal(only_dw[1], first[1])


@pytest.mark.parametrize("groups,cout,pad", [((24, 3), 3, 0), ((24, 3), 3, 2), ((32, 16), 16, 0)],
                         ids=["K2-valid", "K2-full", "K1-valid"])
def test_forward_and_backward_at_other_paddings(cuda, groups, cout, pad):
    """A 3 x 3 window without padding (the output two pixels smaller) and
    with padding 2 (two larger): forward against the plain version, then
    ``check_grads``."""
    x, m, w, b = _case(cuda, 85 + pad + cout, 2, 21, 19, groups, cout, 3, True)
    kw = dict(group_sizes=groups, padding=(pad, pad))
    got = kpc.partial_conv2d_fused(x, m, w, b, **kw)
    assert got[0].shape == (2, 19 + 2 * pad, 17 + 2 * pad, cout)
    check_close("forward", got, kpc.partial_conv2d_reference(x, m, w, b, **kw), require_empty=True)
    check_grads(f"K3 pad {pad}", x, m, w, b, _cotangent(cuda, got[0].shape), kw)


def test_k3_all_hole_page_passes_no_gradient(cuda):
    """Every window empty: dx, dW and db exactly 0 on both routes, whatever
    x holds."""
    for groups, cout in (((64, 3), 3), ((32, 16), 16)):
        x, m, w, b = _case(cuda, 90 + cout, 2, 21, 19, groups, cout, 3, True)
        x[0, 0, 0, 0] = float("inf")
        g = _cotangent(cuda, (2, 21, 19, cout))
        out = kpc.partial_conv2d_backward(g, x, torch.zeros_like(m), w.to(torch.bfloat16),
                                          b.to(torch.bfloat16), groups, (1, 1))
        for a in out:
            assert (a == 0).all()


def test_k3_launches_are_bit_identical_and_counted(cuda):
    x, m, w, _ = _case(cuda, 95, 4, 32, 32, (64, 32), 64, 3, False)
    g = _cotangent(cuda, (4, 32, 32, 64))
    wb = w.to(torch.bfloat16)
    bb = torch.zeros((64,), device=cuda, dtype=torch.bfloat16)
    before = kpc.K3_LAUNCHES
    first = kpc.partial_conv2d_backward(g, x, m, wb, bb, (64, 32), (1, 1))
    again = kpc.partial_conv2d_backward(g, x, m, wb, bb, (64, 32), (1, 1))
    torch.cuda.synchronize()
    assert kpc.K3_LAUNCHES == before + 2
    for a, a2 in zip(first, again):
        assert torch.equal(a, a2)
    want = kpc.partial_conv2d_backward_reference(g, x, m, wb, bb, (64, 32), (1, 1))
    for a, r in zip(first, want):  # the same products, perhaps by another cuDNN engine
        top = r.float().abs().max().item()
        torch.testing.assert_close(a.float(), r.float(), rtol=2**-7, atol=2e-3 * top)


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


@pytest.mark.parametrize("m,h,w", [(2, 512, 512), *STEM_EXTRA],
                         ids=[f"{m}x{h}x{w}" for m, h, w in [(2, 512, 512), *STEM_EXTRA]])
def test_stem_kernels_over_the_persistent_grid(cuda, m, h, w):
    """K4 and K5 where the tiles outnumber the SMs (2048 tiles), where one
    tile is the whole grid, and at a partial last wave (143 tiles on 132
    SMs): against their plain versions, and two launches bit-identical
    (``check_stem_dx``, ``check_stem_pool``)."""
    gen = torch.Generator(cuda).manual_seed(m * h + w)
    w0, b0, w1, b1 = stem_weights(gen, cuda)
    x = torch.randn((m, h, w, 3), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((m, h // 2, w // 2, 64), generator=gen, device=cuda).to(torch.bfloat16)
    z0 = torch.randn((m, h, w, 64), generator=gen, device=cuda).to(torch.bfloat16)
    k4, k5 = kvs.K4_LAUNCHES, kvs.K5_LAUNCHES
    check_stem_dx(f"K4 {m}x{h}x{w}", x, g, w0, b0, w1, b1, compare_max=h * w * m >= 2**19)
    check_stem_dx_repeats(f"K4 {m}x{h}x{w}", x, g, w0, b0, w1, b1)
    check_stem_pool(f"K5 {m}x{h}x{w}", z0, w1, b1)
    assert (kvs.K4_LAUNCHES - k4, kvs.K5_LAUNCHES - k5) == (3, 2)


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


@pytest.mark.parametrize("name,n,h,w,c,k,d,dtype", K6_RAGGED, ids=[r[0] for r in K6_RAGGED])
def test_k6_matches_truth(cuda, name, n, h, w, c, k, d, dtype):
    """Odd maps, C off the 32-channel tile, k = 5, f32 inputs, and a 4^2
    map at d = 4 (every off-centre tap in the padding: exactly 0)."""
    gen = torch.Generator(cuda).manual_seed(n * h * w + c)
    x = torch.randn((n, h, w, c), generator=gen, device=cuda).to(dtype)
    dy = torch.randn((n, h, w, c), generator=gen, device=cuda).to(dtype)
    check_wgrad(name, x, dy, k, d)
    if h == w == 4:
        dw = kdw.depthwise_wgrad(x, dy, k, d)
        dw[k // 2, k // 2] = 0
        assert (dw == 0).all()


def test_depthwise_backward_launches_k6(cuda, monkeypatch):
    """The Function's backward on CUDA with the flag on: K6 once, dW in the
    weight's dtype, rounded once from the plain f32 sum (up to its
    summation order), and dy taken from autograd with another layout (an
    NCHW tensor's view)."""
    monkeypatch.setattr(depthwise, "USE_CUSTOM_WGRAD", True)
    gen = torch.Generator(cuda).manual_seed(11)
    c, d = 192, 2
    x = torch.randn((2, 24, 20, c), generator=gen, device=cuda).to(torch.bfloat16)
    wt = (torch.randn((c, 1, 3, 3), generator=gen, device=cuda) * 0.3).to(torch.bfloat16)
    wt.requires_grad_(True)
    g = torch.randn((2, c, 24, 20), generator=gen, device=cuda).to(torch.bfloat16)
    before = kdw.K6_LAUNCHES
    depthwise.depthwise_conv2d(x, wt, d).backward(g.permute(0, 2, 3, 1))
    torch.cuda.synchronize()
    assert kdw.K6_LAUNCHES == before + 1
    want = kdw.depthwise_wgrad_reference(x, g.permute(0, 2, 3, 1), 3, d).permute(3, 2, 0, 1)
    assert wt.grad.dtype == torch.bfloat16
    torch.testing.assert_close(wt.grad.float(), want, rtol=2**-8, atol=1e-5 * want.abs().max().item())


def test_depthwise_backward_dx_is_the_flipped_conv(cuda):
    """The Function's dx on the card (the depthwise kernel with its taps
    flipped) is the flipped-kernel conv of the same bf16 values, within one
    bf16 step plus 1e-5 of max |ref| for the order of the sums."""
    from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d

    gen = torch.Generator(cuda).manual_seed(12)
    c = 144
    for d in (1, 2, 4):
        x = torch.randn((2, 20, 18, c), generator=gen, device=cuda).to(torch.bfloat16)
        x.requires_grad_(True)
        wt = (torch.randn((c, 1, 3, 3), generator=gen, device=cuda) * 0.3).to(torch.bfloat16)
        g = torch.randn((2, 20, 18, c), generator=gen, device=cuda).to(torch.bfloat16)
        depthwise.depthwise_conv2d(x, wt, d).backward(g)
        want = conv2d(g.float(), wt.float().flip((2, 3)), padding=d, dilation=d, groups=c)
        assert x.grad.dtype == torch.bfloat16 and x.grad.is_contiguous()
        torch.testing.assert_close(x.grad.float(), want, rtol=2**-8,
                                   atol=1e-5 * want.abs().max().item())


def test_k6_result_is_a_channels_major_view(cuda):
    """dW comes back as (k, k, 1, C), a view of a (C, k*k) tensor: the
    Function's permutation to (C, 1, k, k) needs no copy."""
    x = torch.randn((1, 8, 8, 128), device=cuda).to(torch.bfloat16)
    dw = kdw.depthwise_wgrad(x, x, 3, 1)
    assert tuple(dw.shape) == (3, 3, 1, 128)
    assert dw.permute(3, 2, 0, 1).is_contiguous()


def test_k6_workspace_shared_across_shapes(cuda):
    """Calls of other shapes share K6's partial sums and tickets: results
    stay bit-identical when they alternate (every launch leaves its tickets
    at zero)."""
    gen = torch.Generator(cuda).manual_seed(13)
    cases = [(torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16), d)
             for shape, d in (((8, 32, 32, 384), 2), ((2, 9, 11, 200), 1), ((40, 8, 8, 960), 1))]
    first = [kdw.depthwise_wgrad(x, x.flip(1), 3, d) for x, d in cases]
    for _ in range(2):
        for (x, d), want in zip(reversed(cases), reversed(first)):
            assert torch.equal(kdw.depthwise_wgrad(x, x.flip(1), 3, d), want)


def test_k6_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 8, 8, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        kdw._launch_k6(x.permute(0, 2, 1, 3), x, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kdw._launch_k6(x, x.transpose(1, 2), 3, 1)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        kdw._launch_k6(x.half(), x.half(), 3, 1)
    with pytest.raises(ValueError, match="dy must match"):
        kdw._launch_k6(x, x.float(), 3, 1)
    with pytest.raises(ValueError, match="odd k"):
        kdw._launch_k6(x, x, 4, 1)


def test_k6_takes_any_dilation(cuda):
    """A dilation past the map (up to 2^31 - 1) leaves only the centre tap
    in the image: dW bit-equal to that at d = max(H, W), against the plain
    version at d = max(H, W)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 8, 12, 128), generator=gen, device=cuda).to(torch.bfloat16)
    dy = torch.randn((2, 8, 12, 128), generator=gen, device=cuda).to(torch.bfloat16)
    at_w = kdw.depthwise_wgrad(x, dy, 9, 12)
    want = kdw.depthwise_wgrad_reference(x, dy, 9, 12)
    assert torch.allclose(at_w, want, rtol=0, atol=1e-5 * (x.float() * dy.float()).abs().sum())
    for d in (13, 5000, (1 << 24) + 1, (1 << 31) - 1):
        assert torch.equal(kdw.depthwise_wgrad(x, dy, 9, d), at_w)


def test_dense_serve_is_run_bit_for_bit(cuda):
    """The page server on the card (prefetcher stream, pinned results,
    depth 2, and chunk 2 with a flushed tail) returns exactly what
    ``run`` gives on the same uint8 pages, with K1 and K2 launched as
    many times as ``run`` was dispatched."""
    from text_segmentation_image_inpainting_tpu_torch.models import TextSegmenter
    from text_segmentation_image_inpainting_tpu_torch.pipeline import (
        PageStreamServer,
        TextRemovalPipeline,
    )
    from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import to_compute
    from text_segmentation_image_inpainting_tpu_torch.pipeline.sparse import to_uint8

    pipe = TextRemovalPipeline(TextSegmenter(width_mult=0.35, dtype=torch.bfloat16),
                               InpaintUNet(depth=3, dtype=torch.bfloat16)).init_weights(
        torch.Generator().manual_seed(3)).to(cuda).eval()
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8) for _ in range(5)]
    want = []
    for pages in batches:
        clean, mask = pipe.run(to_compute(torch.from_numpy(pages).to(cuda), pipe.compute_dtype))
        want.append((to_uint8(clean).cpu().numpy(), mask.to(torch.uint8).cpu().numpy()))
    kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0
    served = list(PageStreamServer(pipe, depth=2).serve(iter(batches)))
    chunked = PageStreamServer(pipe, chunk=2)
    for pages in batches:
        chunked.submit(pages)
    served += list(chunked.drain())
    assert (kpc.K1_LAUNCHES, kpc.K2_LAUNCHES) == (2 * 10, 10)  # depth 3: 2 K1 levels
    assert len(served) == 10
    for (wc, wm), (gc, gm) in zip(want + want, served):
        assert gc.dtype == np.uint8 and gm.dtype == np.uint8
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gm, wm)


def test_k6_at_an_xception_shape(cuda):
    """C 728 bf16 (1456 bytes a pixel) at d 2, the Xception middle flow's."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((2, 64, 64, 728), generator=g, device=cuda).to(torch.bfloat16)
    dy = torch.randn((2, 64, 64, 728), generator=g, device=cuda).to(torch.bfloat16)
    res = check_wgrad("K6 xception 64x64x728 d2", x, dy, 3, 2)
    assert res["vs_plain"] < 1e-2


def test_captured_inpaint_step_replays_eager_bit_for_bit(cuda):
    """Two dispatches of k = 2 (a warm-up step, the capture, 3 replays)
    against 4 eager steps from the same state and batches: every parameter,
    buffer, optimizer state, the lr and the loss terms bit-equal (cuDNN
    deterministic in both; two eager runs are bit-equal first)."""
    from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
        InpaintLossConfig,
        make_vgg,
    )
    from text_segmentation_image_inpainting_tpu_torch.train.config import (
        InpaintTrainConfig,
        OptimizerConfig,
    )
    from text_segmentation_image_inpainting_tpu_torch.train.inpaint import (
        make_inpaint_train_step,
    )
    from text_segmentation_image_inpainting_tpu_torch.train.multistep import make_multi_step
    from text_segmentation_image_inpainting_tpu_torch.train.state import (
        create_train_state,
        learning_rate_at,
    )

    torch.backends.cudnn.deterministic = True
    try:
        loss = InpaintLossConfig(vgg_dtype="bfloat16", fused_stem=True)
        opt = OptimizerConfig(warmup_steps=2)
        cfg = InpaintTrainConfig(depth=3, loss=loss, optimizer=opt)
        torch.manual_seed(0)
        vgg = make_vgg(loss).to(cuda)
        model = InpaintUNet(depth=3, dtype=torch.bfloat16).init_weights(
            torch.Generator().manual_seed(1)).to(cuda)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        g = torch.Generator(device=cuda).manual_seed(2)
        batches = {"image": torch.rand((4, 2, 64, 64, 3), generator=g, device=cuda),
                   "mask": (torch.rand((4, 2, 64, 64, 1), generator=g, device=cuda) > 0.3).float()}
        runs = []
        for how in ("eager", "eager", "graph"):
            model.load_state_dict(init)
            state = create_train_state(model, opt, capturable=True)
            step = make_inpaint_train_step(model, cfg, vgg)
            terms = []
            if how == "eager":
                for i in range(4):
                    state, t = step(state, {k: v[i] for k, v in batches.items()})
                    terms.append(t)
                terms = {k: torch.stack([t[k] for t in terms]) for k in terms[0]}
            else:
                multi = make_multi_step(step)
                for half in (0, 1):
                    state, t = multi(state, {k: v[2 * half:2 * half + 2]
                                             for k, v in batches.items()})
                    terms.append(t)
                terms = {k: torch.cat([t[k] for t in terms]) for k in terms[0]}
            assert state.step == 4
            assert abs(state.lr.item() - learning_rate_at(opt, 4)) <= 1e-6 * learning_rate_at(opt, 4)
            snap = state_snapshot(state)
            snap.update({f"term {k}": v for k, v in terms.items()})
            runs.append(snap)
        eager, again, graph = runs
        for k in eager:
            assert torch.equal(again[k], eager[k]), f"two eager runs differ in {k}"
            assert torch.equal(graph[k], eager[k]), f"the graph run differs from eager in {k}"
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("name,n,h,w,groups,cout,pad", PAD_EXTRA, ids=[r[0] for r in PAD_EXTRA])
def test_unequal_padding_launches_and_matches_plain(cuda, name, n, h, w, groups, cout, pad):
    x, m, wt, b = _case(cuda, n * h + cout, n, h, w, groups, cout, 3, cout <= 7)
    kw = dict(group_sizes=groups, padding=pad)
    wb, bb = wt.to(torch.bfloat16), None if b is None else b.to(torch.bfloat16)
    k1, k2 = kpc.K1_LAUNCHES, kpc.K2_LAUNCHES
    partial_conv2d(x, m, wb, bb, **kw)
    routed = in_kernel_scope((1, 1), (1, 1), wb.shape, h + 2 * pad[0] - 2)
    want = ((0, 1) if cout <= 7 else (1, 0)) if routed else (0, 0)
    assert (kpc.K1_LAUNCHES - k1, kpc.K2_LAUNCHES - k2) == want
    got = kpc.partial_conv2d_fused(x, m, wb, bb, **kw)
    again = kpc.partial_conv2d_fused(x, m, wb, bb, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == (n, h + 2 * pad[0] - 2, w + 2 * pad[1] - 2, cout)
    check_close(name, got, kpc.partial_conv2d_reference(x, m, wb, bb, **kw), require_empty=True)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    check_grads(name, x, m, wt, b, _cotangent(cuda, got[0].shape), kw)


@pytest.mark.parametrize("name,h,w,c_lo,c_skip,cout", SHARD_SHAPES,
                         ids=[r[0] for r in SHARD_SHAPES])
def test_kernels_at_the_shard_shapes(cuda, name, h, w, c_lo, c_skip, cout):
    """A band of 2048 / 4 rows with a halo row from either neighbour,
    padding (0, 1): the output has the band's rows and the page's width."""
    x, m, wt, b = _case(cuda, h + cout, 1, h, w, (c_lo, c_skip), cout, 3, cout <= 7)
    kw = dict(group_sizes=(c_lo, c_skip), padding=(0, 1))
    got = kpc.partial_conv2d_fused(x, m, wt, b, **kw)
    again = kpc.partial_conv2d_fused(x, m, wt, b, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == (1, h - 2, w, cout)
    check_close(name, got, kpc.partial_conv2d_reference(x, m, wt, b, **kw))
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def _small_pipe(cuda, seed):
    from text_segmentation_image_inpainting_tpu_torch.models import TextSegmenter
    from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline

    return TextRemovalPipeline(TextSegmenter(width_mult=0.35, dtype=torch.bfloat16),
                               InpaintUNet(depth=3, dtype=torch.bfloat16)).init_weights(
        torch.Generator().manual_seed(seed)).to(cuda).eval()


def test_spatial_unet_on_the_card(cuda):
    """4 bands of one card, each on its own stream and host thread: K1 2
    and K2 1 launches per band (depth 3), every layer's kernel output as
    in the unsharded forward up to bf16 rounding."""
    from text_segmentation_image_inpainting_tpu_torch.parallel import (
        make_mesh,
        spatial_inpaint_unet,
    )

    rng = np.random.default_rng(5)
    unet = _small_pipe(cuda, 5).unet
    x = torch.from_numpy(rng.uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)).to(cuda)
    m = torch.from_numpy((rng.random((2, 64, 48, 1)) > 0.3).astype(np.float32)).to(cuda)
    x, m = (x * m).to(torch.bfloat16), m.to(torch.bfloat16)
    kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0
    got = spatial_inpaint_unet(make_mesh(devices=[cuda] * 4), unet, x, m)
    assert (kpc.K1_LAUNCHES, kpc.K2_LAUNCHES) == (2 * 4, 4)
    with torch.no_grad():
        want = unet(x, m)
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert got.shape == want.shape and torch.isfinite(got).all() and rel < 2e-2, rel


def test_pipeline2_and_dp_server_on_the_card(cuda):
    """The stage pipeline on (cuda, cuda) and the server over a 2-entry
    mesh of one card: bit-equal to ``run`` per microbatch and per half."""
    from text_segmentation_image_inpainting_tpu_torch.parallel import (
        make_mesh,
        make_stage_mesh,
        pipeline2_run,
    )
    from text_segmentation_image_inpainting_tpu_torch.pipeline import PageStreamServer
    from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import to_compute
    from text_segmentation_image_inpainting_tpu_torch.pipeline.sparse import to_uint8

    pipe = _small_pipe(cuda, 6)
    rng = np.random.default_rng(6)
    pages_mb = torch.from_numpy(rng.uniform(0, 1, (3, 2, 64, 64, 3)).astype(np.float32)).to(cuda)
    got = pipeline2_run(make_stage_mesh([cuda, cuda]), pipe, pages_mb)
    for t in range(3):
        assert torch.equal(got[t], pipe.run(pages_mb[t])[0])
    batches = [rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8) for _ in range(4)]
    served = list(PageStreamServer(pipe, depth=2, mesh=make_mesh(devices=[cuda] * 2)).serve(
        iter(batches)))
    for pages, (gc, gm) in zip(batches, served):
        for half, (hc, hm) in zip(np.split(pages, 2), zip(np.split(gc, 2), np.split(gm, 2))):
            clean, mask = pipe.run(to_compute(torch.from_numpy(half).to(cuda), pipe.compute_dtype))
            np.testing.assert_array_equal(hc, to_uint8(clean).cpu().numpy())
            np.testing.assert_array_equal(hm, mask.to(torch.uint8).cpu().numpy())


@pytest.mark.parametrize("m,h,w", [(1, 16, 16), (2, 32, 48), (2, 18, 26), (2, 512, 512)],
                         ids=["1x16x16", "2x32x48", "2x18x26", "2x512x512"])
def test_k4f_and_k5f_match_plain_in_f64(cuda, m, h, w):
    """K4F and K5F: ``stem_dx`` and ``stem_pool`` on float32 CUDA tensors
    (which raised before the f32 forms existed) against their plain
    versions in f64 (``check_stem_f32``: K4F within 1.25 x the relative L2
    of the f32 cuDNN stem, K5F within 1e-5 (|y| + max |y|)), each twice
    bit-identical, each launch counted."""
    gen = torch.Generator(cuda).manual_seed(m * h + w + 1)
    w0, b0, w1, b1 = stem_weights(gen, cuda)
    x = torch.randn((m, h, w, 3), generator=gen, device=cuda)
    g = torch.randn((m, h // 2, w // 2, 64), generator=gen, device=cuda)
    z0 = torch.randn((m, h, w, 64), generator=gen, device=cuda)
    k4, k5 = kvs.K4F_LAUNCHES, kvs.K5F_LAUNCHES
    check_stem_f32(f"{m}x{h}x{w}", x, g, w0, b0, w1, b1, z0)
    assert (kvs.K4F_LAUNCHES - k4, kvs.K5F_LAUNCHES - k5) == (2, 2)


def test_frozen_stem_in_f32_runs_k4f_and_k5f(cuda):
    """The f32 trunk's stem: a forward with a gradient then K4F for dx, a
    forward without one on K5F; any other non-bf16 dtype raises."""
    gen = torch.Generator(cuda).manual_seed(6)
    w0, b0, w1, b1 = stem_weights(gen, cuda)
    x = torch.rand((2, 16, 16, 3), generator=gen, device=cuda, requires_grad=True)
    k4, k5 = kvs.K4F_LAUNCHES, kvs.K5F_LAUNCHES
    out = kvs.vgg_stem_frozen(x, w0, b0, w1, b1, torch.float32)
    out.sum().backward()
    with torch.no_grad():
        pooled = kvs.vgg_stem_frozen(x, w0, b0, w1, b1, torch.float32)
    assert (kvs.K4F_LAUNCHES - k4, kvs.K5F_LAUNCHES - k5) == (1, 1)
    assert x.grad.dtype == torch.float32 and torch.isfinite(x.grad).all()
    torch.testing.assert_close(pooled, out.detach(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="bfloat16"):
        kvs.stem_dx(x.detach().half(), torch.zeros((2, 8, 8, 64), device=cuda).half(), w0, b0,
                    w1, b1)
    with pytest.raises(ValueError, match="bfloat16"):
        kvs.stem_pool(torch.zeros((1, 16, 16, 64), device=cuda).half(), w1, b1)


# K1F (``pconv_k1f``) away from the U-Net's own layers: (name, N, H, W,
# group sizes, Cout, padding). The split levels at full width, Cin off the
# 16-channel K step, Cout off both CTA tiles, one image, unequal padding
# (these four split K too: their tile grids are small), and a grid of 144
# tiles, which does not split.
K1F_CASES = (
    ("dec7, split K", 8, 4, 4, (512, 512), 512, (1, 1)),
    ("dec6, split K", 8, 8, 8, (512, 512), 512, (1, 1)),
    ("dec5, split K", 8, 16, 16, (512, 512), 512, (1, 1)),
    ("144 tiles, no split", 2, 96, 96, (64, 64), 128, (1, 1)),
    ("Cin 200 = 123 + 77", 3, 37, 29, (123, 77), 72, (1, 1)),
    ("Cout 200", 2, 19, 23, (64, 32), 200, (1, 1)),
    ("batch 1", 1, 32, 32, (256, 256), 256, (1, 1)),
    ("padding (0, 1)", 2, 18, 64, (128, 64), 96, (0, 1)),
)


@pytest.mark.parametrize("name,n,h,w,groups,cout,pad", K1F_CASES, ids=[c[0] for c in K1F_CASES])
def test_k1f_matches_plain_in_f64(cuda, name, n, h, w, groups, cout, pad):
    """K1F (Cout >= 8 in f32) against the plain version in f64
    (``check_f32``: M' bit-exact, y within 1e-5 (|y| + max |y|), 0 in empty
    windows), split K where ``k1f_plan`` says, twice bit-identical."""
    x, m, wt, _ = _case(cuda, h * w + cout, n, h, w, groups, cout, 3, False)
    x, m = x.float(), m.float()
    kw = dict(group_sizes=groups, padding=pad)
    plan = kpc.k1f_plan(n, h, w, sum(groups), cout, 3, pad)
    hout, wout = h + 2 * pad[0] - 2, w + 2 * pad[1] - 2
    assert (plan.splits > 1) == (plan._replace(splits=1).grid(n, hout, wout, cout) < 132)
    assert (plan.splits > 1) == (name != "144 tiles, no split")
    before = kpc.K1F_LAUNCHES
    got = kpc.partial_conv2d_fused(x, m, wt, None, **kw)
    again = kpc.partial_conv2d_fused(x, m, wt, None, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    check_f32(f"K1F {name}", got, x, m, wt, None, kw)
    assert kpc.K1F_LAUNCHES - before == 2


@pytest.mark.parametrize("cin,cout,k,bn", [(1024, 512, 3, 128), (200, 72, 3, 128), (19, 24, 5, 64)])
def test_k1f_weights_are_relaid_as_the_plain_version(cuda, cin, cout, k, bn):
    """``pconv_k1f_weights`` (in K1F's launch) writes ``k1f_weight_relayout``'s
    (k*k, Cin_p, Cout_p) bit for bit, the padding left as the caller set it."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    gen = torch.Generator(cuda).manual_seed(cin + cout)
    x = torch.randn((1, 5, 6, cin), generator=gen, device=cuda)
    m = torch.ones((1, 5, 6, 1), device=cuda)
    wt = torch.randn((cout, cin, k, k), generator=gen, device=cuda)
    want = kpc.k1f_weight_relayout(wt, bn)
    wk = torch.zeros_like(want)
    lib = load_library()
    pad = k // 2
    y = torch.empty((1, 5, 6, cout), device=cuda)
    mo = torch.empty((1, 5, 6, 1), device=cuda)
    xm = torch.empty((1, 5 + 2 * pad, 6 + 2 * pad, want.shape[1]), device=cuda)
    code = lib.tsii_pconv_k1f(x.data_ptr(), m.data_ptr(), wt.data_ptr(), 0, y.data_ptr(),
                              mo.data_ptr(), xm.data_ptr(), 0, wk.data_ptr(), 1, 5, 6, cin, 1,
                              cin, 0, 5, 6, cout, k, pad, pad, want.shape[1], want.shape[2],
                              256 if bn == 64 else 128, bn, 1, 0,
                              torch.cuda.current_stream().cuda_stream)
    check(lib, code, "K1F")
    torch.cuda.synchronize()
    assert torch.equal(wk, want)


def test_stem_f32_weights_are_relaid_as_the_plain_version(cuda):
    """``stem_f32_weights`` (in K4F's and K5F's launches) writes w1f, w1b and
    w0's rows as ``_f32_conv1_taps`` and ``_w0_rows`` lay them out, bit for bit."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    gen = torch.Generator(cuda).manual_seed(8)
    w0, b0, w1, b1 = stem_weights(gen, cuda)
    x = torch.randn((1, 16, 16, 3), generator=gen, device=cuda)
    g = torch.randn((1, 8, 8, 64), generator=gen, device=cuda)
    lib = load_library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    wbuf = torch.full((kvs.STEM_F32_WBUF,), float("nan"), device=cuda)
    a0 = torch.empty((1, 64, 16, 16), device=cuda)
    gz1, dx = torch.empty_like(a0), torch.empty_like(x)
    check(lib, lib.tsii_stem_dx_f32(x.data_ptr(), g.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                                    w1.data_ptr(), b1.data_ptr(), wbuf.data_ptr(), a0.data_ptr(),
                                    gz1.data_ptr(), dx.data_ptr(), 1, 16, 16, sms, stream), "K4F")
    pool_buf = torch.full((9 * 64 * 64,), float("nan"), device=cuda)
    pooled = torch.empty((1, 8, 8, 64), device=cuda)
    check(lib, lib.tsii_stem_pool_f32(a0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                      pool_buf.data_ptr(), pooled.data_ptr(), 1, 16, 16, sms,
                                      stream), "K5F")
    torch.cuda.synchronize()
    w1f, w1b = kvs._f32_conv1_taps(w1)
    w0t = kvs._w0_rows(w0, torch.float32)
    n = 9 * 64 * 64
    assert torch.equal(wbuf[:n], w1f.flatten()) and torch.equal(wbuf[n:2 * n], w1b.flatten())
    assert torch.equal(wbuf[2 * n:], w0t.flatten()) and torch.equal(pool_buf, w1f.flatten())


# K2F and its backward at ragged shapes: (name, N, H, W, groups, Cout, k,
# padding). W off the strips (96 output columns forward, 32 nseg input
# columns backward), H shorter than the ring, one image, Cin 67 and Cin < 4,
# Cout 1 and 7, k 1, 3 and 5 (the backward at k 5 is the general form).
K2F_CASES = (
    ("head channels, W 100: a ragged second strip", 2, 19, 100, (64, 3), 3, 3, (1, 1)),
    ("H 2: shorter than the ring", 2, 2, 37, (64, 3), 3, 3, (1, 1)),
    ("batch 1, Cin 3, Cout 1", 1, 23, 41, (3,), 1, 3, (1, 1)),
    ("Cin 2 + 1, Cout 7, k 5", 2, 17, 29, (2, 1), 7, 5, (2, 2)),
    ("Cin 67, Cout 7, k 5, padding (0, 1), W 200", 1, 12, 200, (64, 3), 7, 5, (0, 1)),
    ("Cout 1, k 1, padding (1, 0)", 3, 9, 97, (16, 3), 1, 1, (1, 0)),
)
K2F_NEEDS = ((True, True, True), (True, False, False), (False, True, False), (False, False, True))


def _k2f_case(cuda, n, h, w, groups, cout, k):
    x, m, wt, b = _case(cuda, n * h * w + cout + k, n, h, w, groups, cout, k, True)
    return x.float(), m.float(), wt, b


@pytest.mark.parametrize("name,n,h,w,groups,cout,k,pad", K2F_CASES, ids=[c[0] for c in K2F_CASES])
def test_k2f_matches_plain_in_f64(cuda, name, n, h, w, groups, cout, k, pad):
    """K2F (Cout <= 7 in f32) against the plain version in f64
    (``check_f32``: M' bit-exact, y within 1e-5 (|y| + max |y|), 0 in empty
    windows), twice bit-identical, counted as K2F."""
    x, m, wt, b = _k2f_case(cuda, n, h, w, groups, cout, k)
    kw = dict(group_sizes=groups, padding=pad)
    before = kpc.K2F_LAUNCHES
    got = kpc.partial_conv2d_fused(x, m, wt, b, **kw)
    again = kpc.partial_conv2d_fused(x, m, wt, b, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    check_f32(f"K2F {name}", got, x, m, wt, b, kw)
    assert kpc.K2F_LAUNCHES - before == 2


@pytest.mark.parametrize("needs", K2F_NEEDS, ids=["all", "dx", "dW", "db"])
@pytest.mark.parametrize("name,n,h,w,groups,cout,k,pad", K2F_CASES, ids=[c[0] for c in K2F_CASES])
def test_k2f_bwd_matches_plain_in_f64(cuda, name, n, h, w, groups, cout, k, pad, needs):
    """K2F's backward (``pconv_k3_prep``, ``pconv_k2f_bwd``, ``pconv_colsum``;
    at k 5 the general form, ``k2f_bwd_plan``) for each ``needs`` subset
    against autograd of the plain version in f64:
    each asked gradient within 1e-5 relative L2, the others None; twice
    bit-identical."""
    x, m, wt, b = _k2f_case(cuda, n, h, w, groups, cout, k)
    hout, wout = h + 2 * pad[0] - k + 1, w + 2 * pad[1] - k + 1
    g = torch.randn((n, hout, wout, cout), generator=torch.Generator(cuda).manual_seed(5),
                    device=cuda)
    got = kpc.partial_conv2d_backward(g, x, m, wt, b, groups, pad, needs)
    again = kpc.partial_conv2d_backward(g, x, m, wt, b, groups, pad, needs)
    ref = [t.detach().double().requires_grad_(True) for t in (x, wt, b)]
    y_ref, _ = kpc.partial_conv2d_reference(ref[0], m.double(), ref[1], ref[2],
                                            group_sizes=groups, padding=pad)
    want = torch.autograd.grad(y_ref, ref, g.double())
    for what, need, a, a2, r in zip(("dx", "dW", "db"), needs, got, again, want):
        if not need:
            assert a is None and a2 is None, what
            continue
        assert a.dtype == torch.float32 and a.shape == r.shape and torch.equal(a, a2), what
        rel = ((a.double() - r).norm() / r.norm().clamp_min(1e-30)).item()
        assert rel < 1e-5, (what, rel)


@pytest.mark.parametrize("cin,cout,k", [(67, 3, 3), (19, 7, 3), (3, 1, 1)])
def test_k2f_weights_are_relaid_as_the_plain_version(cuda, cin, cout, k):
    """``pconv_f32_relay`` in K2F's launch writes ``f32_weight_relayout``'s
    (k*k, Cin, Cout), and in the backward's ``f32_bwd_weight_relayout``'s
    (k*k, Cout, Cin), bit for bit."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    gen = torch.Generator(cuda).manual_seed(cin + cout + k)
    n, h, w, pad = 1, 5, 6, k // 2
    x = torch.randn((n, h, w, cin), generator=gen, device=cuda)
    m = torch.ones((n, h, w, 1), device=cuda)
    wt = torch.randn((cout, cin, k, k), generator=gen, device=cuda)
    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    wk = torch.full((k * k, cin, cout), float("nan"), device=cuda)
    y, mo = torch.empty((n, h, w, cout), device=cuda), torch.empty((n, h, w, 1), device=cuda)
    check(lib, lib.tsii_pconv_k2f(x.data_ptr(), m.data_ptr(), wt.data_ptr(), 0, y.data_ptr(),
                                  mo.data_ptr(), wk.data_ptr(), n, h, w, cin, 1, cin, 0, h, w,
                                  cout, k, pad, pad, 1, stream), "K2F")
    wkb = torch.full((k * k, cout, cin), float("nan"), device=cuda)
    dacc, dx = torch.zeros((n, h, w, cout), device=cuda), torch.empty_like(x)
    plan = kpc.k2f_bwd_plan(n, h, w, cin, cout, k)
    check(lib, lib.tsii_pconv_k2f_bwd(dacc.data_ptr(), x.data_ptr(), m.data_ptr(), wt.data_ptr(),
                                      dx.data_ptr(), 0, wkb.data_ptr(), n, h, w, cin, 1, cin, h, w,
                                      cout, k, pad, pad, plan.rb, plan.nseg, 1, 0, stream),
          "K2F's backward")
    torch.cuda.synchronize()
    assert torch.equal(wk, kpc.f32_weight_relayout(wt))
    assert torch.equal(wkb, kpc.f32_bwd_weight_relayout(wt))
    assert torch.equal(dx, torch.zeros_like(dx))


@pytest.mark.parametrize("m,h,w", STEM_EXTRA + ((3, 176, 208),),
                         ids=[f"{m}x{h}x{w}" for m, h, w in STEM_EXTRA + ((3, 176, 208),)])
def test_k4f_at_stem_extra_and_a_partial_last_wave(cuda, m, h, w):
    """K4F and K5F at every ``STEM_EXTRA`` shape and at 3 pages of 176 x 208,
    whose tiles leave a partial last wave of both conv1 passes' persistent
    grids: ``check_stem_f32``, each twice bit-identical."""
    if (m, h, w) == (3, 176, 208):
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        for mode in ("grad", "dgrad"):
            tiles, grid = kvs.stem_f32_tiles(m, h, w, mode), kvs.stem_f32_grid(m, h, w, mode, sms)
            assert tiles > grid and tiles % grid, (mode, tiles, grid)
    gen = torch.Generator(cuda).manual_seed(m * h * w)
    w0, b0, w1, b1 = stem_weights(gen, cuda)
    x = torch.randn((m, h, w, 3), generator=gen, device=cuda)
    g = torch.randn((m, h // 2, w // 2, 64), generator=gen, device=cuda)
    z0 = torch.randn((m, h, w, 64), generator=gen, device=cuda)
    check_stem_f32(f"{m}x{h}x{w}", x, g, w0, b0, w1, b1, z0)


def test_spatial_pipeline_on_the_card(cuda):
    """``spatial_pipeline_run`` over 2 bands of one card (depth 3, bf16):
    K1 2 and K2 1 launches per band, non-text pixels bit-identical to the
    page, binary masks; against ``run`` (cuDNN may pick other algorithms
    for a band's shape) the masks differ in under 1% of the pixels and the
    clean pages agree where the masks do, within 2% relative L2."""
    from text_segmentation_image_inpainting_tpu_torch.parallel import (
        make_mesh,
        spatial_pipeline_run,
    )

    pipe = _small_pipe(cuda, 7)
    pages = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (2, 64, 48, 3))
                             .astype(np.float32)).to(cuda)
    with torch.no_grad():  # some 1% text before the dilation, not the whole page
        logits = pipe.seg(pages.to(pipe.compute_dtype))[..., 0].float()
        pipe.seg.decoder.head.bias.sub_(torch.quantile(logits.flatten(), 0.99))
    kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0
    clean, mask = spatial_pipeline_run(make_mesh(devices=[cuda] * 2), pipe, pages)
    assert (kpc.K1_LAUNCHES, kpc.K2_LAUNCHES) == (2 * 2, 2)
    want_clean, want_mask = pipe.run(pages)
    assert clean.shape == want_clean.shape and mask.shape == want_mask.shape
    assert ((mask == 0) | (mask == 1)).all() and torch.isfinite(clean).all()
    keep = (mask == 0).expand_as(clean)
    assert torch.equal(clean[keep], pages.to(clean.dtype)[keep])
    assert 0.005 < float(want_mask.float().mean()) < 0.95
    agree = (mask == want_mask).expand_as(clean)
    assert float((mask != want_mask).float().mean()) < 0.01
    a, b = clean[agree].float(), want_clean[agree].float()
    assert ((a - b).norm() / b.norm()).item() < 2e-2


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", SCOPE_CASES, ids=[c[0] for c in SCOPE_CASES])
def test_kernels_take_jaxs_scope(cuda, case, dt):
    """A shape of JAX's scope that no model reaches, through ``partial_conv2d``:
    the kernel's counter moves (its templated or general form), the forward
    against the f64 truth with M' bit-exact, twice bit-identical; the
    backward by chip_smoke.py's gates (``check_grads`` in bf16,
    ``check_grads_f32`` in f32, twice bit-identical)."""
    name, n, h, w, groups, cout, k, pad = case
    gen = torch.Generator(device=cuda).manual_seed(sum(groups) + k)
    x, m, wt, b = scope_case_inputs(gen, np.random.default_rng(k), cuda, n, h, w, groups, cout, k)
    xd, md, wd, bd = (t.to(dt) for t in (x, m, wt, b))
    kw = dict(group_sizes=groups, padding=pad)
    key = ("K2" if cout <= 7 else "K1") + ("F" if dt == torch.float32 else "")
    before = launch_counters()
    first = partial_conv2d(xd, md, wd, bd, **kw)
    moved = {c: v - before[c] for c, v in launch_counters().items() if v != before[c]}
    assert moved == {key: 1}
    again = kpc.partial_conv2d_fused(xd, md, wd, bd, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    g = torch.randn(first[0].shape, generator=gen, device=cuda).to(dt)
    if dt == torch.float32:
        check_f32(name, first, xd, md, wd, bd, kw)
        check_grads_f32(name, xd, md, wd, bd, g, kw)
    else:
        y64, m64 = kpc.partial_conv2d_reference(xd.double(), md.double(), wd.double(),
                                                bd.double(), **kw)
        check_close(name, first, (y64, m64.to(dt)), require_empty=True)
        check_grads(name, xd, md, wt, b, g, kw)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", SCOPE_K6, ids=[c[0] for c in SCOPE_K6])
def test_k6_general_form(cuda, case, dt):
    """K6 past its templated form (k 9; k 7 at a dilation of 48) runs the
    general form: against the f64 truth, twice bit-identical."""
    name, n, h, w, c, k, d = case
    gen = torch.Generator(device=cuda).manual_seed(k * d)
    x = torch.randn((n, h, w, c), generator=gen, device=cuda).to(dt)
    dy = torch.randn((n, h, w, c), generator=gen, device=cuda).to(dt)
    before = kdw.K6_GEN_LAUNCHES
    check_wgrad(name, x, dy, k, d)
    assert kdw.K6_GEN_LAUNCHES == before + 2


def test_an_output_height_of_12_takes_the_plain_route(cuda):
    """Outside JAX's scope (``_supported``: an output height under 8 or a
    multiple of 8) no kernel launches, in bf16 and f32."""
    x, m, w, _ = _case(cuda, 12, 2, 12, 16, (8, 8), 16, 3, False)
    for dt in (torch.bfloat16, torch.float32):
        before = launch_counters()
        partial_conv2d(x.to(dt), m.to(dt), w.to(dt), group_sizes=(8, 8), padding=1)
        assert launch_counters() == before


# The depthwise kernel away from the cells: (name, N, H, W, C, stride,
# dilation, padding, flip).
DW_RAGGED = (
    ("odd 37x29, C 200, d 2", 3, 37, 29, 200, 1, 2, (2, 2), False),
    ("one channel vector: C 8, 5x7", 1, 5, 7, 8, 1, 1, (1, 1), False),
    ("stride 2 at d 3: runs 3 columns apart", 2, 41, 23, 24, 2, 3, (3, 3), False),
    ("stride 2 at d 2, odd map", 2, 33, 31, 48, 2, 2, (2, 2), False),
    ("a band: H padding 0", 2, 20, 16, 64, 1, 2, (0, 2), False),
    ("dx of a band's conv: padding (4, 2)", 2, 16, 16, 64, 1, 2, (4, 2), True),
    ("every off-centre tap in the padding", 2, 4, 4, 128, 1, 4, (4, 4), False),
    ("partial last wave: 40 pages 8x8, C 960", 40, 8, 8, 960, 1, 1, (1, 1), False),
)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", DW_SHAPES,
                         ids=[f"{m}-C{c}-{h}-s{s}-d{d}" for m, c, h, s, d, _ in DW_SHAPES])
def test_depthwise_conv_at_the_cells_shapes(cuda, case, dt):
    """Every depthwise conv of the cells, on 2 pages: the forward and, at
    stride 1, the flipped dx by ``check_dw``."""
    _, c, h, s, d, _ = case
    gen = torch.Generator(device=cuda).manual_seed(c + h + s + d)
    x = torch.randn((2, h, h, c), generator=gen, device=cuda).to(dt)
    w = torch.randn((c, 1, 3, 3), generator=gen, device=cuda) * 0.3
    check_dw(f"C {c} {h}^2 s {s} d {d}", x, w, s, d, (d, d))
    if s == 1:
        check_dw(f"dx C {c} {h}^2 d {d}", x, w, 1, d, (d, d), flip=True)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", DW_RAGGED, ids=[c[0] for c in DW_RAGGED])
def test_depthwise_conv_away_from_the_cells(cuda, case, dt):
    name, n, h, w, c, s, d, pad, flip = case
    gen = torch.Generator(device=cuda).manual_seed(n * h + w + c)
    x = torch.randn((n, h, w, c), generator=gen, device=cuda).to(dt)
    wt = torch.randn((c, 1, 3, 3), generator=gen, device=cuda) * 0.3
    check_dw(name, x, wt, s, d, pad, flip)
    # a bf16 weight is read as it is: the same bits as the f32 one rounded
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_conv as kdc

    assert torch.equal(kdc.depthwise_conv2d_fused(x, wt.to(dt), s, d, pad, flip),
                       kdc.depthwise_conv2d_fused(x, wt, s, d, pad, flip))


def test_depthwise_routes_by_what_the_input_shows(cuda):
    """A CUDA bf16 or f32 3x3 conv launches the kernel (``dw.kernel``); a
    5x5 one and an f64 one take the plain version (``dw.plain``); an x
    that starts off 16 bytes is copied first, with the same result."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_conv as kdc
    from text_segmentation_image_inpainting_tpu_torch.utils.profiling import counters

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 12, 10, 64), generator=gen, device=cuda)
    for dt, k, route in ((torch.bfloat16, 3, "kernel"), (torch.float32, 3, "kernel"),
                         (torch.bfloat16, 5, "plain"), (torch.float64, 3, "plain")):
        w = torch.randn((64, 1, k, k), generator=gen, device=cuda)
        before, launches = counters(), kdc.DW_LAUNCHES
        y = depthwise.depthwise_conv2d(x.to(dt), w, 2, 1)
        grew = {r: counters().get(f"dw.{r}", 0) - before.get(f"dw.{r}", 0)
                for r in ("kernel", "plain")}
        assert grew == {"kernel": int(route == "kernel"), "plain": int(route == "plain")}
        assert kdc.DW_LAUNCHES - launches == int(route == "kernel")
        want = kdc.depthwise_conv2d_plain(x.to(dt), w, 1, 2, (2 * (k // 2),) * 2)
        torch.testing.assert_close(y.double(), want.double(), rtol=2**-7, atol=1e-3)
    xb = x.to(torch.bfloat16)
    flat = torch.empty(xb.numel() + 1, dtype=torch.bfloat16, device=cuda)
    off = flat[1:].view(xb.shape)
    off.copy_(xb)
    assert off.data_ptr() % 16 and off.is_contiguous()
    w = torch.randn((64, 1, 3, 3), generator=gen, device=cuda)
    assert torch.equal(kdc.depthwise_conv2d_fused(off, w, 1, 1, (1, 1)),
                       kdc.depthwise_conv2d_fused(xb, w, 1, 1, (1, 1)))


@pytest.mark.parametrize("s", [1, 2])
def test_depthwise_function_dx(cuda, s):
    """Training: at stride 1 x's gradient is the kernel's flipped conv of
    dy, bit for bit; at stride 2 cuDNN's dgrad, within one bf16 rounding
    (relative L2 1e-2) of the f64 gradient."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_conv as kdc

    gen = torch.Generator(device=cuda).manual_seed(s)
    x = torch.randn((2, 16, 12, 128), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((128, 1, 3, 3), generator=gen, device=cuda) * 0.3).requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    y = depthwise.depthwise_conv2d(xr, w, 2, s)
    dy = torch.randn(y.shape, generator=gen, device=cuda).to(torch.bfloat16)
    y.backward(dy)
    if s == 1:
        assert torch.equal(xr.grad, kdc.depthwise_conv2d_fused(dy, w, 1, 2, (2, 2), flip=True))
    x64 = x.double().requires_grad_(True)
    y64 = torch.nn.functional.conv2d(x64.permute(0, 3, 1, 2), w.detach().to(torch.bfloat16)
                                     .double(), None, s, 2, 2, 128)
    y64.backward(dy.double().permute(0, 3, 1, 2))
    rel = ((xr.grad.double() - x64.grad).norm() / x64.grad.norm()).item()
    assert rel < 1e-2 and w.grad.dtype == torch.float32
