"""The f32 kernels' plans and summation orders (K1F, K4F), on the CPU.

K1F (``pconv_k1f``) and K4F (``stem_f32_conv1`` and ``stem_f32_dx``) run
only on the card; what surrounds them is held here. ``k1f_plan`` at the
U-Net's 8 layers and at ragged shapes: its split ranges cover every K step
once, contiguously; it splits exactly where the tile grid is smaller than
the card (dec7..dec5), to at least 132 CTAs, and never at dec4..dec1; it
is a pure function of the shape. The plans' constants are the CUDA
source's own. Then each kernel's order of sums, emulated in f32 torch on
the CPU, is held to JAX's XLA twin in f64 within the gate the card applies
(chip_smoke.py): K1F's split partials, each a chain over its K steps
(tap-major, 16 channels a step) added in split order, within 1e-5 (|y| +
max |y|) of ``_partial_conv2d_xla``, M' exact; K4F's dgrads in their
blocks (conv1's: 8 channels x 9 taps apart, then the block sums in order;
conv0's: each tap's 64 terms, then the tap sums) within 1.25x the relative
L2 of the plain f32 stem to the autodiff of ``stem_forward_xla``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SHAPES
from tests.test_torch_bridge import one_torch_thread
from tests.test_torch_vgg import _oihw, _stem_weights
from text_segmentation_image_inpainting_tpu.ops import partial_conv as jpc
from text_segmentation_image_inpainting_tpu.ops.pallas import vgg_stem_bwd as jstem_bwd
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import apply_mask

CSRC = Path(kpc.__file__).resolve().parents[2] / "csrc"
BATCH, SMS = 8, 132
SPLIT_LEVELS = ("dec7", "dec6", "dec5")
# K1F away from the U-Net: (N, H, W, Cin, Cout, k, padding). Cin off the
# 16-channel step, Cout off both tiles, one image, unequal padding, k 1/5,
# and a grid just under and just over the card.
RAGGED = (
    (3, 37, 29, 200, 72, 3, (1, 1)),
    (1, 6, 16, 1024, 512, 3, (1, 0)),
    (2, 13, 11, 19, 24, 5, (2, 2)),
    (2, 9, 7, 40, 16, 1, (0, 0)),
    (1, 4, 4, 33, 200, 3, (0, 1)),
    (4, 64, 64, 96, 40, 3, (1, 1)),
    (1, 120, 128, 64, 64, 3, (1, 1)),
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _constexpr(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text()).group(1))


def _level(name):
    _, h, c_lo, c_skip, cout = next(s for s in SHAPES if s[0] == name)
    return BATCH, h, h, c_lo + c_skip, cout, 3, (1, 1)


def _all_shapes():
    return [_level(s[0]) for s in SHAPES] + list(RAGGED)


def test_k1f_constants_are_the_kernels():
    """The plan's K step, CTAs an SM and tiles are csrc/partial_conv.cu's."""
    assert kpc.K1F_CK == _constexpr("partial_conv.cu", "K1F_CK")
    assert kpc.K1F_CTAS == _constexpr("partial_conv.cu", "K1F_CTAS")
    src = (CSRC / "partial_conv.cu").read_text()
    for bm, bn in kpc.K1F_TILES:
        assert f"(bm == {bm} && bn == {bn})" in src and f"pconv_k1f<{bm}, {bn}>" in src
    assert kvs.STEM_F32_CTAS == _constexpr("vgg_stem.cu", "SF_CTAS")
    assert all(tw == _constexpr("vgg_stem.cu", "SF_TW") for _, tw in kvs.STEM_F32_TILES.values())


@pytest.mark.parametrize("shape", _all_shapes(), ids=lambda s: "x".join(map(str, s[:5])))
def test_k1f_split_ranges_cover_every_step_once(shape):
    n, h, w, cin, cout, k, pad = shape
    plan = kpc.k1f_plan(n, h, w, cin, cout, k, pad)
    steps = kpc.k1f_steps(cin, k)
    ranges = kpc.k1_split_ranges(steps, plan.splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == steps
    assert all(a < b for a, b in ranges)  # none empty
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    assert (plan.bm, plan.bn) in kpc.K1F_TILES and (plan.bn == 64) == (cout <= 64)


@pytest.mark.parametrize("name", [s[0] for s in SHAPES[:7]])
def test_k1f_splits_only_the_small_levels(name):
    """dec7..dec5 split K to at least one CTA an SM (and at most the CTAs
    the card holds); dec4..dec1 fill the card with tiles and never split."""
    n, h, w, cin, cout, k, pad = _level(name)
    plan = kpc.k1f_plan(n, h, w, cin, cout, k, pad)
    grid = plan.grid(n, h, w, cout)
    if name in SPLIT_LEVELS:
        assert plan.splits > 1 and SMS <= grid <= kpc.K1F_CTAS * SMS
    else:
        assert plan.splits == 1 and grid >= SMS


def test_k1f_plan_is_a_pure_function_of_the_shape():
    first = [kpc.k1f_plan(*s) for s in _all_shapes()]
    again = [kpc.k1f_plan(*s) for s in reversed(_all_shapes())][::-1]
    assert first == again
    n, h, w, cin, cout, k, pad = RAGGED[0]
    assert kpc.k1f_plan(n, h, w, cin, cout, k, pad) == kpc.k1f_plan(n, h, w, cin, cout, k,
                                                                     list(pad))


def _k1f_emulated(x, m, w, b, groups, pad, splits):
    """K1F's arithmetic in f32 torch: x * M zero-padded, then per split a
    chain over its K steps (tap-major; a step's 16 channels in order), the
    splits added in order, then the epilogue."""
    n, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    ph, pw = pad
    hout, wout = h + 2 * ph - k + 1, wd + 2 * pw - k + 1
    xm = torch.nn.functional.pad(apply_mask(x, m, groups), (0, 0, pw, pw, ph, ph))
    wt = kpc.k1f_weight_relayout(w, 64)[:, :cin, :cout]  # (k*k, Cin, Cout)
    nck = -(-cin // kpc.K1F_CK)
    steps = k * k * nck
    total = None
    for s0, s1 in kpc.k1_split_ranges(steps, splits):
        acc = torch.zeros((n, hout, wout, cout), dtype=torch.float32)
        for s in range(s0, s1):
            tap, chunk = divmod(s, nck)
            dy, dx = divmod(tap, k)
            win = xm[:, dy:dy + hout, dx:dx + wout]
            for c in range(chunk * kpc.K1F_CK, min(cin, (chunk + 1) * kpc.K1F_CK)):
                acc = acc + win[..., c:c + 1] * wt[tap, c]
        total = acc if total is None else total + acc
    msum = torch.from_numpy(np.array(jpc.mask_window_sum(
        jnp.asarray(m.numpy()), groups, (k, k), stride=(1, 1), padding=pad)))
    scale = float(k * k * cin) / torch.clamp(msum, min=1.0)
    y = total * scale + (0.0 if b is None else b)
    return torch.where(msum > 0, y, torch.zeros(())), (msum > 0).float()


@pytest.mark.parametrize("n,h,w,groups,cout,k,pad,bias", [
    (2, 6, 5, (20, 13), 24, 3, (1, 1), False),
    (1, 7, 9, (33,), 16, 3, (0, 1), True),
    (2, 5, 6, (9, 8), 12, 5, (2, 1), False),
], ids=["G2-3x3", "G1-pad01", "k5"])
@pytest.mark.parametrize("splits", [1, 4, 7])
def test_k1f_split_order_matches_jax_in_f64(n, h, w, groups, cout, k, pad, bias, splits):
    rng = np.random.default_rng(sum(groups) + cout + splits)
    cin = sum(groups)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    m = (rng.random((n, h, w, len(groups))) < 0.6).astype(np.float32)
    m[0, :k, :k] = 0
    wt = (rng.standard_normal((cout, cin, k, k)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    y, m_out = _k1f_emulated(torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(wt),
                             None if b is None else torch.from_numpy(b), groups, pad, splits)
    with jax.enable_x64():
        want, want_m = jpc._partial_conv2d_xla(
            jnp.asarray(x, jnp.float64), jnp.asarray(m, jnp.float64),
            jnp.asarray(wt.transpose(2, 3, 1, 0), jnp.float64),
            None if b is None else jnp.asarray(b, jnp.float64), groups, (1, 1), pad, (1, 1))
        want, want_m = np.asarray(want), np.asarray(want_m)
    np.testing.assert_array_equal(m_out.numpy(), want_m)
    err = np.abs(y.double().numpy() - want)
    assert (err <= 1e-5 * (np.abs(want) + np.abs(want).max())).all(), err.max()
    assert (y.numpy()[want_m[..., 0] == 0] == 0).all()


def _taps(t):
    """The 9 shifted views of NHWC ``t`` for a 3x3 'same' conv, tap (ky, kx)
    = t[p + (ky - 1, kx - 1)], zero outside."""
    n, h, w, _ = t.shape
    tp = torch.nn.functional.pad(t, (0, 0, 1, 1, 1, 1))
    return [tp[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)]


def _k4f_emulated(x, g, w0, b0, w1, b1):
    """K4F in f32 torch: the forward products as one sum each (they feed
    only the pool and its routing), conv1's dgrad in blocks of 8 channels x
    9 taps added in order, conv0's dgrad per tap (64 terms in order), the
    tap sums in order."""
    m, h, w, _ = x.shape
    a0 = torch.relu(torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w0, b0, padding=1))
    z1 = torch.nn.functional.conv2d(a0, w1, b1, padding=1).permute(0, 2, 3, 1)
    a0 = a0.permute(0, 2, 3, 1)
    win = z1.reshape(m, h // 2, 2, w // 2, 2, 64).permute(0, 1, 3, 2, 4, 5).reshape(
        m, h // 2, w // 2, 4, 64)
    first = torch.nn.functional.one_hot(torch.relu(win).argmax(dim=3), 4).permute(0, 1, 2, 4, 3)
    gz1 = (first * (win > 0) * g[:, :, :, None, :]).reshape(m, h // 2, w // 2, 2, 2, 64).permute(
        0, 1, 3, 2, 4, 5).reshape(m, h, w, 64)
    _, w1b = kvs._f32_conv1_taps(w1)  # (tap, in = conv1's output channel, out)
    shifted = _taps(gz1)
    tot = torch.zeros_like(gz1)
    for c0 in range(0, 64, 8):
        acc = torch.zeros_like(gz1)
        for c in range(c0, c0 + 8):
            for tap in range(9):
                acc = acc + shifted[tap][..., c:c + 1] * w1b[tap, c]
        tot = tot + acc
    gz0 = torch.where(a0 > 0, tot, torch.zeros(()))
    w0t = kvs._w0_rows(w0, torch.float32)  # (64 out, 27), k = tap * 3 + in
    shifted = _taps(gz0)
    dx = torch.zeros((m, h, w, 3))
    for tap in range(9):  # gz0[p + (1 - ky, 1 - kx)]: tap 8 - t of the shifted views
        a = torch.zeros((m, h, w, 3))
        for o in range(64):
            a = a + shifted[8 - tap][..., o:o + 1] * w0t[o, 3 * tap:3 * tap + 3]
        dx = dx + a
    return dx


@pytest.mark.parametrize("m,h,w", [(2, 16, 24), (1, 18, 26)], ids=["2x16x24", "1x18x26"])
def test_k4f_blocked_dgrads_match_jax_in_f64(m, h, w):
    w0, b0, w1, b1 = _stem_weights(h + w)
    rng = np.random.default_rng(m * h + w)
    x = rng.standard_normal((m, h, w, 3)).astype(np.float32)
    g = rng.standard_normal((m, h // 2, w // 2, 64)).astype(np.float32)
    with jax.enable_x64():
        _, vjp = jax.vjp(lambda v: jstem_bwd.stem_forward_xla(
            v, *(jnp.asarray(a, jnp.float64) for a in (w0, b0, w1, b1)), jnp.float64),
            jnp.asarray(x, jnp.float64))
        (truth,) = vjp(jnp.asarray(g, jnp.float64))
        truth = torch.from_numpy(np.array(truth))
    tw = [_oihw(w0), torch.from_numpy(b0), _oihw(w1), torch.from_numpy(b1)]
    got = _k4f_emulated(torch.from_numpy(x), torch.from_numpy(g), *tw)
    plain = kvs.stem_dx_reference(torch.from_numpy(x), torch.from_numpy(g), *tw)

    def rel(a):
        return ((a.double() - truth).norm() / truth.norm()).item()

    assert rel(got) <= 1.25 * rel(plain), (rel(got), rel(plain))


@pytest.mark.parametrize("m,h,w", [(16, 512, 512), (1, 176, 208), (3, 176, 208), (2, 18, 26)])
def test_stem_f32_grids(m, h, w):
    """The conv1 passes' persistent grids: two CTAs an SM or one a tile;
    GRAD/POOL tiles 16 x 16, DGRAD 8 x 16."""
    for mode, (th, tw) in kvs.STEM_F32_TILES.items():
        tiles = m * -(-h // th) * -(-w // tw)
        assert kvs.stem_f32_tiles(m, h, w, mode) == tiles
        assert kvs.stem_f32_grid(m, h, w, mode, SMS) == min(tiles, 2 * SMS)
