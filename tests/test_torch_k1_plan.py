"""K1's launch plan and operand layouts, on the CPU.

The wrapper of K1 (``ops/kernels/partial_conv.py``) decides in Python
what the kernel only follows: the tile (BM x BN) and the split of K
(``k1_plan``, ``k1_split_ranges``), and the layouts of x and the weights
(``k1_channels``, ``k1_input_relayout``, ``k1_weight_relayout``). These
tests hold the plan at the U-Net's seven decoder shapes (512² pages,
batch 8: every K step covered exactly once, no split empty, at least one
full wave of 132 CTAs, the halo form at dec2 and dec1), the layouts against the plain weight permutation,
and an emulation of the kernel's arithmetic built from those pieces (the
zero-filled gather, per-split partial sums added in split order, the
epilogue) against the plain version, in f32.
"""

import numpy as np
import pytest
import torch

from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import (
    mask_window_sum,
    pconv_epilogue,
)
from tests.test_torch_bridge import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


SMS = 132
# (level, N, H = W, Cout, Cin) of InpaintUNet(depth=8)'s decoder at 512^2, batch 8
DECODER = (
    ("dec7", 8, 4, 512, 1024),
    ("dec6", 8, 8, 512, 1024),
    ("dec5", 8, 16, 512, 1024),
    ("dec4", 8, 32, 512, 1024),
    ("dec3", 8, 64, 256, 768),
    ("dec2", 8, 128, 128, 384),
    ("dec1", 8, 256, 64, 192),
)


def _grid(p, cout, plan, splits):
    return -(-p // plan.bm) * -(-(-(-cout // 8) * 8) // plan.bn) * splits


@pytest.mark.parametrize("level,n,h,cout,cin", DECODER, ids=[d[0] for d in DECODER])
def test_plan_at_the_decoder_shapes(level, n, h, cout, cin):
    gb, cin_x, cin_p = kpc.k1_channels((cin // 2, cin - cin // 2))
    assert (gb, cin_x, cin_p) == (cin // 2, cin, cin)  # no re-lay at the U-Net's shapes
    plan = kpc.k1_plan(n, h, h, cout, cin_p, 3, 1)
    assert (plan.bm, plan.bn) in ((128, 64), (128, 128), (128, 256), (256, 64), (256, 128))
    assert plan.bn <= max(64, cout)
    steps = plan.steps(cin_p, 3)
    ranges = kpc.k1_split_ranges(steps, plan.splits)
    covered = [s for b, e in ranges for s in range(b, e)]
    assert covered == list(range(steps))  # each K step once, in order
    assert all(e > b for b, e in ranges)
    p = n * h * h
    assert _grid(p, cout, plan, plan.splits) >= SMS
    if _grid(p, cout, plan, 1) >= SMS:
        assert plan.splits == 1  # a full grid never splits
    assert kpc.k1_plan(n, h, h, cout, cin_p, 3, 1) == plan


def test_the_plans_at_the_decoder_levels():
    """The deep levels split K; the gather form's tile and splits take the
    fewest waves x steps x stage bytes; the two widest levels take the halo
    form; one step of the halo form is a window row (3 taps)."""
    plans = {level: kpc.k1_plan(n, h, h, cout, cin, 3, 1) for level, n, h, cout, cin in DECODER}
    assert plans == {
        "dec7": (False, 128, 128, 33), "dec6": (False, 128, 128, 16),
        "dec5": (False, 128, 256, 8), "dec4": (False, 128, 256, 2),
        "dec3": (False, 128, 256, 1), "dec2": (True, 128, 128, 1), "dec1": (True, 256, 64, 1),
    }
    assert plans["dec1"].steps(192, 3) == 9 and plans["dec3"].steps(768, 3) == 108


def test_gather_cost_counts_waves_steps_and_partials():
    cost = kpc._k1_gather_cost
    # dec4 (8192 pixels, Cout 512, 144 steps): 256 tiles of 128 x 128 in 2
    # waves cost as much as 128 tiles of 128 x 256 split in 2, plus the partials
    whole = cost(256, 144, 128, 128, 1, 8192, 512)
    split = cost(128, 144, 128, 256, 2, 8192, 512)
    assert split < whole
    assert split - cost(128, 144, 128, 256, 2, 0, 512) == pytest.approx(2 * 2 * 8192 * 512 * 4
                                                                         / 3.35e12)
    # a 133rd CTA costs a whole wave
    assert cost(133, 10, 128, 128, 1, 1, 8) == pytest.approx(2 * cost(132, 10, 128, 128, 1, 1, 8))


@pytest.mark.parametrize("n,h,w,cout,cin_p,k,pad", [
    (1, 1, 1, 8, 64, 1, 0), (3, 37, 29, 72, 256, 3, 1), (2, 13, 17, 200, 64, 3, 1),
    (2, 5, 5, 16, 64, 5, 2), (8, 4, 4, 512, 1024, 3, 1), (4, 500, 500, 24, 64, 3, 1),
    (2, 3, 128, 72, 256, 3, 1), (2, 6, 64, 40, 128, 3, 1), (1, 9, 9, 16, 64, 3, 0),
    (8, 64, 256, 40, 128, 3, 1),
])
def test_plan_covers_every_step_with_no_empty_split(n, h, w, cout, cin_p, k, pad):
    plan = kpc.k1_plan(n, h, w, cout, cin_p, k, pad)
    steps = plan.steps(cin_p, k)
    ranges = kpc.k1_split_ranges(steps, plan.splits)
    assert 1 <= plan.splits <= steps and len(ranges) == plan.splits
    assert [s for b, e in ranges for s in range(b, e)] == list(range(steps))
    assert all(e > b for b, e in ranges)
    p = n * (h + 2 * pad - k + 1) * (w + 2 * pad - k + 1)
    assert _grid(p, cout, plan, plan.splits) >= min(SMS, _grid(p, cout, plan, 1) * steps)
    assert plan.halo == (k == 3 and pad == 1 and w in (64, 128, 256) and cout <= 128)
    if plan.halo:
        assert plan.bm == (256 if (w, cout) == (256, 40) else 128)


@pytest.mark.parametrize("groups,want", [
    ((512, 512), (512, 1024, 1024)), ((64,), (64, 64, 64)), ((123, 77), (128, 208, 256)),
    ((5, 14), (8, 24, 64)), ((64, 3), (64, 72, 128)),
])
def test_channel_layout(groups, want):
    assert kpc.k1_channels(groups) == want


def _weight(cout, cin, k, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((cout, cin, k, k))
                            .astype(np.float32))


def test_weight_relayout_is_one_permute_at_the_unet_shapes():
    w = _weight(64, 192, 3)
    got = kpc.k1_weight_relayout(w, (128, 64))
    want = w.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, 64, 192)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, want)
    # the same numbers as the (tap, Cin, Cout) permutation, transposed per tap
    assert torch.equal(got, w.to(torch.bfloat16).permute(2, 3, 1, 0).reshape(9, 192, 64)
                       .transpose(1, 2))


@pytest.mark.parametrize("level,n,h,cout,cin", DECODER, ids=[d[0] for d in DECODER])
def test_weight_relayout_at_the_decoder_shapes(level, n, h, cout, cin):
    """Each decoder level's groups are (the upsampled level below, the skip
    of Cout channels): its re-lay is the (tap, Cout, Cin) permutation, bf16,
    no padding, the same on every call."""
    groups = (cin - cout, cout)
    w = _weight(cout, cin, 3, seed=cout)
    got = kpc.k1_weight_relayout(w, groups)
    want = w.to(torch.bfloat16).permute(2, 3, 1, 0).reshape(9, cin, cout).transpose(1, 2)
    assert got.shape == (9, cout, cin) and got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(kpc.k1_weight_relayout(w, groups), got)


@pytest.mark.parametrize("groups,cout,k", [((123, 77), 72, 3), ((5, 14), 12, 5), ((40,), 13, 1)])
def test_weight_relayout_pads_with_zeros_off_the_tile(groups, cout, k):
    cin = sum(groups)
    w = _weight(cout, cin, k, seed=cin)
    gb, cin_x, cin_p = kpc.k1_channels(groups)
    got = kpc.k1_weight_relayout(w, groups)
    cout_p = -(-cout // 8) * 8
    assert got.shape == (k * k, cout_p, cin_p)
    plain = w.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(k * k, cout, cin)
    s0 = groups[0]
    assert torch.equal(got[:, :cout, :s0], plain[..., :s0])
    assert torch.equal(got[:, :cout, gb:gb + cin - s0], plain[..., s0:])
    keep = torch.zeros_like(got, dtype=torch.bool)
    keep[:, :cout, :s0] = True
    keep[:, :cout, gb:gb + cin - s0] = True
    assert (got[~keep] == 0).all()


def test_input_relayout():
    x = torch.randn(2, 5, 7, 128, dtype=torch.bfloat16)
    assert kpc.k1_input_relayout(x, (64, 64)) is x
    x = torch.randn(2, 5, 7, 19, dtype=torch.bfloat16)
    got = kpc.k1_input_relayout(x, (5, 14))
    assert got.shape == (2, 5, 7, 24)
    assert torch.equal(got[..., :5], x[..., :5]) and torch.equal(got[..., 8:22], x[..., 5:])
    assert (got[..., 5:8] == 0).all() and (got[..., 22:] == 0).all()


def _emulate_k1(x, mask, weight, bias, groups, pad):
    """K1's arithmetic from the wrapper's pieces, in f32 on the CPU: the
    re-laid x, zero-filled wherever the tap lies outside the image or its
    group mask is 0; the re-laid weights; per split, the sum over its K
    steps (tap, 64-channel block); the partials added in split order;
    then the epilogue."""
    n, h, w, cin = x.shape
    cout, _, k, _ = weight.shape
    gb, cin_x, cin_p = kpc.k1_channels(groups)
    hout, wout = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    plan = kpc.k1_plan(n, h, w, cout, cin_p, k, pad)
    xk = torch.zeros((n, h + 2 * pad, w + 2 * pad, cin_p))
    xk[:, pad:pad + h, pad:pad + w, :cin_x] = kpc.k1_input_relayout(x, groups).float()
    gate = torch.zeros((n, h + 2 * pad, w + 2 * pad, cin_p))
    grp = (torch.arange(cin_p) >= gb).long() if len(groups) == 2 else torch.zeros(cin_p).long()
    gate[:, pad:pad + h, pad:pad + w] = (mask.float()[..., grp] != 0).float()
    xk = xk * gate
    wk = kpc.k1_weight_relayout(weight, groups).float()
    chunks = cin_p // 64
    partials = []
    for b, e in kpc.k1_split_ranges(plan.steps(cin_p, k), plan.splits):
        acc = torch.zeros((n, hout, wout, wk.shape[1]))
        for s in range(b, e):
            # a step: (tap, 64 channels), or in the halo form (window row, 64 channels)
            row_or_tap, cb = divmod(s, chunks)
            taps = range(row_or_tap * k, row_or_tap * k + k) if plan.halo else (row_or_tap,)
            for tap in taps:
                dy, dx = divmod(tap, k)
                a = xk[:, dy:dy + hout, dx:dx + wout, cb * 64:(cb + 1) * 64]
                acc += a @ wk[tap, :, cb * 64:(cb + 1) * 64].T
        partials.append(acc)
    acc = partials[0]
    for part in partials[1:]:
        acc = acc + part
    msum = mask_window_sum(mask, groups, (k, k), stride=(1, 1), padding=(pad, pad))
    b = None if bias is None else bias.to(x.dtype).float()
    return pconv_epilogue(acc[..., :cout], msum, b, float(k * k * cin), x.dtype)


@pytest.mark.parametrize("n,h,w,groups,cout,k,bias", [
    (8, 4, 4, (64, 64), 16, 3, False),      # split K
    (3, 9, 7, (23, 17), 12, 3, True),       # groups off the 8-channel chunk, split K
    (1, 16, 16, (64,), 8, 1, False),        # G 1, 1x1
    (2, 6, 5, (40, 30), 24, 5, True),       # k 5
    (2, 3, 128, (123, 77), 72, 3, False),   # the halo form, ragged
    (2, 6, 64, (96,), 40, 3, True),         # the halo form, two rows per tile
])
def test_emulated_kernel_matches_the_plain_version(n, h, w, groups, cout, k, bias):
    rng = np.random.default_rng(n * h + k)
    cin = sum(groups)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(np.float32)).to(torch.bfloat16)
    m = torch.from_numpy((rng.random((n, h, w, len(groups))) < 0.6).astype(np.float32))
    m[0, :k + 1, :k + 1] = 0
    m = m.to(torch.bfloat16)
    wt = _weight(cout, cin, k, seed=cout) / np.sqrt(k * k * cin)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)) if bias else None
    y, m_out = _emulate_k1(x, m, wt, b, groups, k // 2)
    y_ref, m_ref = kpc.partial_conv2d_reference(x, m, wt, b, group_sizes=groups,
                                                padding=(k // 2, k // 2))
    assert torch.equal(m_out, m_ref)
    # the same f32 sums in another order, each rounded once to bf16
    err = (y.float() - y_ref.float()).abs()
    assert (err <= 2.0**-7 * y_ref.float().abs() + 1e-3 * y_ref.float().abs().max()).all()
    assert (y[m_out[..., 0] == 0] == 0).all()
