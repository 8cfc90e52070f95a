"""The f32 kernels' plans and summation orders (K1F, K4F, K2F and its
backward), on the CPU.

K1F (``pconv_k1f``), K4F (``stem_f32_conv1`` and ``stem_f32_dx``) and K2F
(``pconv_k2f``, ``pconv_k2f_bwd``) run only on the card; what surrounds
them is held here. ``k1f_plan`` at the U-Net's 8 layers and at ragged
shapes: its split ranges cover every K step once, contiguously; it splits
exactly where the tile grid is smaller than the card (dec7..dec5), to at
least 132 CTAs, and never at dec4..dec1; it is a pure function of the
shape. ``k2f_plan`` and ``k2f_bwd_plan``: bands that cover every row once,
the head's grid in whole waves of two CTAs an SM, the backward's threads
(one per segment and channel) and the shapes they refuse. The plans'
constants are the CUDA source's own. Then each kernel's order of sums,
emulated in f32 torch on the CPU, is held to JAX's XLA twin in f64 within
the gate the card applies (chip_smoke.py): K1F's split partials, each a
chain over its K steps (tap-major, 16 channels a step) added in split
order, within 1e-5 (|y| + max |y|) of ``_partial_conv2d_xla``, M' exact;
K4F's dgrads in their blocks (conv1's: 8 channels x 9 taps apart, then the
block sums in order; conv0's: each tap's 64 terms, then the tap sums)
within 1.25x the relative L2 of the plain f32 stem to the autodiff of
``stem_forward_xla``; K2F's warps' sums (each over the input rows, the
warp's channels, the row's taps) added in warp order, within the same 1e-5
gate, M' exact; its backward's dx (one chain a window row, added in
order) and dW (each segment's sums over its band's rows and pixels, the
segments added in order, the CTAs' rows by ``pconv_colsum``'s order)
within 1e-5 relative L2 of ``jax.vjp`` of the XLA twin in f64.
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


# K2F and its backward: G 2 as (16, 3), every Cout of 1, 3, 7 with every k
# of 1, 3, 5 once, each padding three times; then the head's channels.
K2F_CASES = (
    ((16, 3), 1, 1, (1, 1)), ((16, 3), 3, 1, (0, 1)), ((16, 3), 7, 1, (1, 0)),
    ((16, 3), 1, 3, (1, 0)), ((16, 3), 3, 3, (1, 1)), ((16, 3), 7, 3, (0, 1)),
    ((16, 3), 1, 5, (0, 1)), ((16, 3), 3, 5, (1, 0)), ((16, 3), 7, 5, (1, 1)),
    ((64, 3), 3, 3, (1, 1)),
)
# The backward's: its templated form takes k 1 and 3 (K2F_BWD_KS); the
# k 5 cases' groups and paddings at Cin 19 + 3 and at k 3 stand in for them.
K2F_BWD_CASES = tuple(case for case in K2F_CASES if case[2] in kpc.K2F_BWD_KS) + (
    ((19, 3), 1, 3, (0, 1)), ((19, 3), 3, 3, (1, 0)), ((19, 3), 7, 3, (1, 1)),
)


def _k2f_ids(case):
    groups, cout, k, pad = case
    return f"G{'+'.join(map(str, groups))}-cout{cout}-k{k}-pad{pad[0]}{pad[1]}"


def test_k2f_constants_are_the_kernels():
    """The plans' ring depths, tile widths, threads and CTAs an SM, the
    windows built and the shared-memory terms are csrc/partial_conv.cu's."""
    for name in ("K2F_R", "K2F_THREADS", "K2F_RING", "K2F_CTAS", "HB_SEG", "HB_NSEG",
                 "HB_THREADS", "HB_RING"):
        assert getattr(kpc, name) == _constexpr("partial_conv.cu", name), name
    src = (CSRC / "partial_conv.cu").read_text()
    assert re.search(r"constexpr int K2F_TW = 32 \* K2F_R;", src) and kpc.K2F_TW == 32 * kpc.K2F_R
    fwd_macro = src.split("#define TSII_K2F_COUT(C, CALL)")[1].split("#define")[0]
    bwd_macro = src.split("#define TSII_K2F_BWD_COUT(C, CALL)")[1].split("#define")[0]
    ks = re.findall(r"case C \* 8 \+ (\d+): CALL\(C, \1\)", fwd_macro)
    bwd_ks = re.findall(r"case C \* 8 \+ (\d+): CALL\(C, \1\)", bwd_macro)
    couts = re.findall(r"TSII_K2F_COUT\((\d+), CALL\)", src)
    assert tuple(sorted(map(int, ks))) == kpc.K2F_KS
    assert tuple(sorted(map(int, bwd_ks))) == kpc.K2F_BWD_KS
    assert "TSII_K2F_BWD_SWITCH(cout, k, K2F_CALL)" in src
    assert sorted(map(int, couts)) == list(range(1, 8))
    assert "return (pixels * cin + 6 + 3) / 4 * 4;" in src
    assert "return (k2f_row_floats(pixels, cin) + 2 * pixels + 3) / 4 * 4;" in src
    assert re.search(r"K2F_RING \* k2f_stage_floats\(K2F_TW \+ k - 1, cin\) \+ cin \* wpc \+\s+"
                     r"8 \* K2F_TW \* cout \+ 2 \* k \* \(K2F_TW \+ k - 1\)\) \* 4", src)
    assert re.search(r"\(size_t\)HB_RING \* k2f_stage_floats\(tw, cin\) \+\s+"
                     r"\(size_t\)\(HB_RING \+ k - 1\) \* \(tw \+ k - 1\) \* "
                     r"\(\(cout \+ 3\) / 4 \* 4\)", src)
    assert "(size_t)nseg * k * k * cout * cin" in src
    assert "__launch_bounds__(K2F_THREADS, K2F_CTAS) pconv_k2f(" in src
    assert "__launch_bounds__(HB_THREADS, K2F_CTAS) pconv_k2f_bwd(" in src


def test_k2f_head_fills_whole_waves_of_two_ctas():
    """At the head (8 x 512^2, 67 -> 3, k 3) both kernels hold two CTAs an SM
    by shared memory, and their grids are 2 full waves of 264 CTAs."""
    n, h, w, cin, cout, k = BATCH, 512, 512, 67, 3, 3
    fwd = kpc.k2f_plan(n, h, w, cin, cout, k, (1, 1))
    bwd = kpc.k2f_bwd_plan(n, h, w, cin, cout, k)
    assert 2 * (kpc.k2f_smem_bytes(cin, cout, k) + 1024) <= 233472
    assert 2 * (kpc.k2f_bwd_smem_bytes(cin, cout, k, bwd.nseg) + 1024) <= 233472
    assert (fwd.tw, fwd.threads) == (96, 256) and (bwd.nseg, bwd.tw, bwd.threads) == (3, 96, 224)
    assert fwd.grid(n, h, w) == bwd.grid(n, h, w) == 2 * 2 * SMS


@pytest.mark.parametrize("n,rows,cols,cin,k", [
    (8, 512, 512, 67, 3), (1, 2, 37, 67, 5), (3, 37, 29, 3, 1), (2, 100, 300, 19, 7),
    (1, 1, 1, 1, 3), (16, 64, 64, 150, 3),
])
def test_k2f_bands_cover_every_row_once(n, rows, cols, cin, k):
    bwd = kpc.k2f_bwd_plan(n, rows, cols, cin, 3, k)
    assert bwd.general == (k not in kpc.K2F_BWD_KS)  # past k 3 the general backward
    for plan in (kpc.k2f_plan(n, rows + k - 1, cols + k - 1, cin, 3, k, (0, 0)),
                 *(() if bwd.general else (bwd,))):
        bands = -(-rows // plan.rb)
        assert 1 <= plan.rb <= rows and (bands - 1) * plan.rb < rows <= bands * plan.rb
        assert plan.grid(n, rows, cols) == n * bands * -(-cols // plan.tw)
        assert plan.threads % 32 == 0 and plan.nseg * cin <= plan.threads <= 256
    if not bwd.general:
        assert bwd.nseg == min(kpc.HB_NSEG, kpc.HB_THREADS // cin) and bwd.tw == 32 * bwd.nseg


@pytest.mark.parametrize("cin,cout,k,what", [
    (67, 8, 3, "Cout"), (67, 3, 2, "k in"), (67, 3, 9, "k in"), (300, 3, 3, "input channels"),
])
def test_k2f_refuses_what_it_is_not_built_for(cin, cout, k, what):
    """Cout 8 is K1F's: both plans refuse it. The rest of JAX's scope that
    the templated forms are not built for (a window outside K2F_KS, a ring
    too large for shared memory, more than HB_THREADS input channels
    backward) takes the general form."""
    if what == "Cout":
        with pytest.raises(ValueError, match=what):
            kpc.k2f_bwd_plan(2, 16, 16, cin, cout, k)
        with pytest.raises(ValueError, match=what):
            kpc.k2f_plan(2, 16, 16, cin, cout, k, (1, 1))
        return
    assert kpc.k2f_bwd_plan(2, 16, 16, cin, cout, k).general
    fwd = kpc.k2f_plan(2, 16, 16, cin, cout, k, (1, 1))
    assert fwd.general == (k not in kpc.K2F_KS
                           or kpc.k2f_smem_bytes(cin, cout, k) > kpc.SMEM_LIMIT)


def _k2f_inputs(groups, cout, k, seed, n=2, h=9, w=70):
    rng = np.random.default_rng(seed)
    cin = sum(groups)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    m = (rng.random((n, h, w, len(groups))) < 0.6).astype(np.float32)
    m[0, :k + 1, :k + 1] = 0  # a window that sees no valid pixel
    wt = (rng.standard_normal((cout, cin, k, k)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, m, wt, b, rng


def _msum(m, groups, k, pad):
    return torch.from_numpy(np.array(jpc.mask_window_sum(
        jnp.asarray(m), groups, (k, k), stride=(1, 1), padding=pad)))


def _k2f_emulated(x, m, w, b, groups, pad):
    """K2F's arithmetic in f32 torch: warp w sums over the input rows (dy),
    its channels [Cin w / 8, Cin (w + 1) / 8), then the row's taps; the 8
    warps' sums are added in warp order, then the epilogue."""
    n, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    ph, pw = pad
    hout, wout = h + 2 * ph - k + 1, wd + 2 * pw - k + 1
    xm = torch.nn.functional.pad(apply_mask(x, m, groups), (0, 0, pw, pw, ph, ph))
    total = None
    for warp in range(kpc.K2F_THREADS // 32):
        acc = torch.zeros((n, hout, wout, cout), dtype=torch.float32)
        for dy in range(k):
            for c in range(warp * cin // 8, (warp + 1) * cin // 8):
                for dx in range(k):
                    acc = acc + xm[:, dy:dy + hout, dx:dx + wout, c:c + 1] * w[:, c, dy, dx]
        total = acc if total is None else total + acc
    msum = _msum(m.numpy(), groups, k, pad)
    scale = float(k * k * cin) / torch.clamp(msum, min=1.0)
    y = total * scale + b
    return torch.where(msum > 0, y, torch.zeros(())), (msum > 0).float()


def _xla_f64(x, m, wt, b, groups, pad):
    def f(xv, wv, bv):
        return jpc._partial_conv2d_xla(xv, jnp.asarray(m, jnp.float64), wv.transpose(2, 3, 1, 0),
                                       bv, groups, (1, 1), pad, (1, 1))
    return f, tuple(jnp.asarray(a, jnp.float64) for a in (x, wt, b))


@pytest.mark.parametrize("case", K2F_CASES, ids=_k2f_ids)
def test_k2f_warp_order_matches_jax_in_f64(case):
    groups, cout, k, pad = case
    x, m, wt, b, _ = _k2f_inputs(groups, cout, k, sum(groups) + 10 * cout + k)
    y, m_out = _k2f_emulated(*(torch.from_numpy(a) for a in (x, m, wt, b)), groups, pad)
    with jax.enable_x64():
        f, args = _xla_f64(x, m, wt, b, groups, pad)
        want, want_m = (np.asarray(a) for a in f(*args))
    np.testing.assert_array_equal(m_out.numpy(), want_m)
    err = np.abs(y.double().numpy() - want)
    assert (err <= 1e-5 * (np.abs(want) + np.abs(want).max())).all(), err.max()
    assert (y.numpy()[want_m[..., 0] == 0] == 0).all() and (want_m == 0).any()


def _dacc_window(dacc, h, w, k, pad):
    """win[n, ih, iw, (dy * k + dx) * Cout + o] = dacc[n, ih + ph - dy, iw + pw
    - dx, o], 0 outside: the backward's dacc window of input pixel (ih, iw)."""
    ph, pw = pad
    dp = torch.nn.functional.pad(dacc, (0, 0, k - 1, k - 1, k - 1, k - 1))
    taps = [dp[:, ph - dy + k - 1:ph - dy + k - 1 + h, pw - dx + k - 1:pw - dx + k - 1 + w]
            for dy in range(k) for dx in range(k)]
    return torch.cat(taps, dim=-1)


def _k2f_bwd_emulated(x, m, w, g, groups, pad):
    """The backward in f32 torch after ``pconv_k3_prep``'s dacc: dx, one
    chain per window row (its taps, then Cout, in order) and the rows'
    chains added in order, times the mask; dW, per CTA of ``k2f_bwd_plan``
    and segment of 32 columns a sum over the band's rows and the segment's
    pixels in order, the segments added in order, the CTAs' rows by
    ``pconv_colsum`` (8 strided chains, then their sums in order)."""
    n, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    msum = _msum(m.numpy(), groups, k, pad)
    scale = torch.where(msum > 0, float(k * k * cin) / torch.clamp(msum, min=1.0), 0.0)
    dacc = torch.where(scale > 0, g * scale, torch.zeros(()))
    win = _dacc_window(dacc, h, wd, k, pad)  # (n, h, w, k*k*Cout), (tap, o)
    dx = None
    for dy in range(k):
        s = torch.zeros((n, h, wd, cin))
        for dxx in range(k):
            for o in range(cout):
                t = (dy * k + dxx) * cout + o
                s = s + win[..., t:t + 1] * w[o, :, dy, dxx]
        dx = s if dx is None else dx + s
    dx = apply_mask(dx, m, groups)
    plan = kpc.k2f_bwd_plan(n, h, wd, cin, cout, k)
    xm = apply_mask(x, m, groups)
    rows = []
    for img in range(n):
        for ih0 in range(0, h, plan.rb):
            for iw0 in range(0, wd, plan.tw):
                segs = []
                for sa in range(iw0, iw0 + plan.tw, kpc.HB_SEG):
                    acc = torch.zeros((k * k * cout, cin))
                    for ih in range(ih0, min(ih0 + plan.rb, h)):
                        for iw in range(sa, min(sa + kpc.HB_SEG, wd)):
                            acc = acc + xm[img, ih, iw][None, :] * win[img, ih, iw][:, None]
                    segs.append(acc)
                rows.append(sum(segs[1:], segs[0]))
    chains = [sum(rows[y + 8::8], rows[y]) if y < len(rows) else torch.zeros_like(rows[0])
              for y in range(8)]
    dw = sum(chains[1:], chains[0]).reshape(k, k, cout, cin).permute(2, 3, 0, 1)
    return dx, dw


@pytest.mark.parametrize("case", K2F_BWD_CASES, ids=_k2f_ids)
def test_k2f_bwd_orders_match_jax_vjp_in_f64(case):
    groups, cout, k, pad = case
    x, m, wt, b, rng = _k2f_inputs(groups, cout, k, 7 * sum(groups) + cout + k)
    n, h, wd, _ = x.shape
    hout, wout = h + 2 * pad[0] - k + 1, wd + 2 * pad[1] - k + 1
    g = rng.standard_normal((n, hout, wout, cout)).astype(np.float32)
    dx, dw = _k2f_bwd_emulated(*(torch.from_numpy(a) for a in (x, m, wt, g)), groups, pad)
    with jax.enable_x64():
        f, args = _xla_f64(x, m, wt, b, groups, pad)
        _, vjp = jax.vjp(lambda *a: f(*a)[0], *args)
        want_dx, want_dw, _ = (np.asarray(a) for a in vjp(jnp.asarray(g, jnp.float64)))
    for what, got, want in (("dx", dx, want_dx), ("dW", dw, want_dw)):
        rel = np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want)
        assert rel < 1e-5, (what, rel)


def test_plain_version_holds_an_f64_x_in_f64():
    """The truth the f32 forms are held to on the card (chip_smoke's
    ``check_f32`` and ``check_grads_f32``, the gpu tests) is the plain
    version on f64 inputs: its conv and, through autograd, both gradient
    products run in f64 (they ran in f32 before), with the f32 window scale
    that JAX's epilogue and the kernels take; so does the plain backward
    (its cotangent was rounded to f32)."""
    groups, cout, k, pad = (64, 3), 3, 3, (1, 1)
    x, m, wt, b, rng = _k2f_inputs(groups, cout, k, 41, h=11, w=13)
    g = torch.from_numpy(rng.standard_normal((2, 11, 13, cout)))
    x, wt, b = (torch.from_numpy(a.astype(np.float64)) for a in (x, wt, b))
    m = torch.from_numpy(m).double()
    leaves = [t.clone().requires_grad_(True) for t in (x, wt, b)]
    y, _ = kpc.partial_conv2d_reference(*leaves[:1], m, *leaves[1:], group_sizes=groups,
                                        padding=pad)
    got = torch.autograd.grad(y, leaves, g)
    msum = _msum(m.float().numpy(), groups, k, pad)
    scale = torch.where(msum > 0, float(k * k * sum(groups)) / torch.clamp(msum, min=1.0),
                        0.0).double()
    xm = apply_mask(x, m, groups).permute(0, 3, 1, 2)
    feat = torch.nn.functional.conv2d(xm, wt, padding=pad).permute(0, 2, 3, 1)
    want_y = torch.where(scale > 0, feat * scale + b, 0.0)
    dacc = (g * scale).permute(0, 3, 1, 2)
    want_dx = apply_mask(torch.nn.grad.conv2d_input(xm.shape, wt, dacc, padding=pad)
                         .permute(0, 2, 3, 1), m, groups)
    want_dw = torch.nn.grad.conv2d_weight(xm, wt.shape, dacc, padding=pad)
    want_db = (g * (scale > 0)).sum(dim=(0, 1, 2))
    plain = kpc.partial_conv2d_backward_reference(g, x, m, wt, b, groups, pad)
    assert y.dtype == torch.float64 and all(a.dtype == torch.float64 for a in plain)
    for a, r in zip((y, *got[:2], *plain), (want_y, want_dx, want_dw, want_dx, want_dw, want_db)):
        assert (a - r).abs().max().item() <= 1e-12 * r.abs().max().item()
