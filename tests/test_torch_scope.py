"""JAX's Pallas scope in the port, on the CPU: the routing, the kernels'
plans over that scope, the general forms' arithmetic, and parity with JAX
at shapes that no model of the repo reaches.

* ``ops/partial_conv.py::in_kernel_scope`` is JAX's ``_supported``
  (``ops/pallas/partial_conv_kernel.py:532-539``) over a sweep of strides,
  dilations, windows and output heights; in bf16 at an output height of
  12, outside that scope, the port's partial conv is JAX's
  ``impl='pallas'`` (which takes ``_partial_conv2d_xla`` there) in all but
  at most 1% of the outputs, each at most one bf16 step apart.
* Every plan returns over k 1..15, Cin 1..1024, Cout 1..7 (K1 and K1F at
  Cout >= 8) and 1..4 mask groups, and K6's over odd k up to 31 and
  dilations up to 5000: the templated form within its shared memory, as
  the ``.cu`` files' constants give it, and below the routing cut, else the
  general form; the general forms' plan (``gen_plan``) up to k 31, within
  SMEM_LIMIT and GEN_PART_FLOATS, its tile constants and shared-memory
  terms read from the ``.cu``; the routing cut pinned at the head; K6's
  general plan (``k6_gen_plan``) within SMEM_LIMIT, computing every
  in-image (pixel, tap) once, its f32 chain under 167.
* The general forms (``csrc/partial_conv.cu``: ``pconv_gen_fwd_bf16`` /
  ``_f32``, ``pconv_gen_dx_bf16`` / ``_f32``, ``pconv_gen_dw_bf16`` /
  ``_f32``; ``csrc/depthwise_wgrad.cu``: ``dw_wgrad_gen_tiles`` and
  ``dw_wgrad_gen_fold``) emulated in
  torch in their own tiling, index arithmetic and order of sums (the mma
  forward's runs of taps and Z shift-add, the SIMT forward's unit and tap
  order, dx's reversed taps within runs, dW's segments of (row, strip)
  items, tap pairs or runs, pixel groups and ``pconv_colsum``'s order),
  with the weights from the wrappers' own re-lays, against ``jax.vjp``, at
  even k, unequal padding, padding above k - 1, three groups, Cin 200, k
  9, 11 and 13; K6's in its rings, tap-row groups, tiles, residue classes,
  lanes' tree and slots' fold at k 9 to 15, d 1 to 48, C 130 and 200.
* The port's ``partial_conv2d`` and its gradients against JAX's
  ``impl='pallas'`` (interpret mode) in f32 at Cin 200 (k 3), Cin 67 at k 2
  and 9, and three mask groups; K6's plain version at k 9 against
  ``jax.vjp`` of JAX's depthwise conv.
"""

import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_bridge import one_torch_thread
from text_segmentation_image_inpainting_tpu.ops import partial_conv as jpc
from text_segmentation_image_inpainting_tpu.ops.conv import conv2d as jconv2d
from text_segmentation_image_inpainting_tpu.ops.pallas.partial_conv_kernel import _supported
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import (
    _partial_conv2d_plain,
    apply_mask,
    in_kernel_scope,
    mask_window_sum,
    partial_conv2d,
    pconv_epilogue,
)

CSRC = Path(__file__).resolve().parents[1] / "text_segmentation_image_inpainting_tpu_torch" / "csrc"
RTOL, ATOL = 1e-3, 1e-4  # tests/test_torch_f32_pconv.py's f32 bounds
SMS = 132
KS = range(1, 16)
CINS = (1, 2, 3, 7, 8, 16, 64, 67, 80, 81, 169, 170, 200, 256, 257, 300, 512, 1000, 1024)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _groups(cin: int, g: int) -> tuple:
    """Cin cut into g groups as even as they come (the last the larger)."""
    base = cin // g
    return tuple([base] * (g - 1) + [cin - base * (g - 1)])


# -- the routing -----------------------------------------------------------------------

@pytest.mark.parametrize("h_out", range(1, 41))
def test_in_kernel_scope_is_jaxs_supported(h_out):
    for stride in ((1, 1), (2, 2), (1, 2)):
        for dil in ((1, 1), (2, 2), (1, 2)):
            for kh, kw in ((3, 3), (3, 1), (1, 1), (2, 2), (5, 5), (11, 11)):
                want = _supported(stride, dil, (kh, kw, 4, 8), h_out)
                assert in_kernel_scope(stride, dil, (8, 4, kh, kw), h_out) == want, (
                    stride, dil, kh, kw)


def _bf16_step(v: np.ndarray) -> np.ndarray:
    """One bf16 step (ulp) at each |v|: 2^(exponent - 7)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 2.0**-126))) - 7)


@pytest.mark.parametrize("h,cout", [(12, 16), (12, 3), (20, 16), (16, 16), (6, 3)])
def test_bf16_partial_conv_routes_as_jax(h, cout):
    """bf16, 1 x H x 10 x 8, k 3: JAX's ``impl='pallas'`` leaves an output
    height of 12 or 20 to ``_partial_conv2d_xla`` (the conv rounded to bf16
    before the f32 epilogue), and so does the port now
    (``_partial_conv2d_plain``); a height of 16 or 6 takes the kernel on
    both sides. At most 1% of the outputs differ, each by at most one bf16
    step (the two convs' summation orders)."""
    rng = np.random.default_rng(h * 31 + cout)
    x = rng.standard_normal((1, h, 10, 8)).astype(np.float32)
    m = (rng.random((1, h, 10, 1)) < 0.7).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, cout)) / np.sqrt(72)).astype(np.float32)
    b = (0.1 * rng.standard_normal((cout,))).astype(np.float32)
    bf = jnp.bfloat16
    want, want_m = jpc.partial_conv2d(jnp.asarray(x, bf), jnp.asarray(m, bf), jnp.asarray(w, bf),
                                      jnp.asarray(b, bf), padding=1, impl="pallas")
    tb = torch.bfloat16
    got, got_m = partial_conv2d(torch.from_numpy(x).to(tb), torch.from_numpy(m).to(tb),
                                torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(tb),
                                torch.from_numpy(b).to(tb), padding=1)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_array_equal(got_m.float().numpy(), np.asarray(want_m.astype(jnp.float32)))
    diff = np.abs(got - want)
    assert (diff > 0).sum() <= 0.01 * got.size, f"{(diff > 0).sum()} of {got.size} differ"
    assert (diff <= _bf16_step(np.maximum(np.abs(got), np.abs(want)))).all(), diff.max()


@pytest.mark.parametrize("h", [12, 20])
def test_outside_the_scope_is_the_plain_route(h):
    """An output height outside JAX's scope takes ``_partial_conv2d_plain``
    bit for bit, in bf16 and f32."""
    rng = np.random.default_rng(h)
    for dt in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(rng.standard_normal((2, h, 9, 11)).astype(np.float32)).to(dt)
        m = torch.from_numpy((rng.random((2, h, 9, 2)) < 0.7).astype(np.float32)).to(dt)
        w = torch.from_numpy(rng.standard_normal((5, 11, 3, 3)).astype(np.float32)).to(dt)
        got = partial_conv2d(x, m, w, None, group_sizes=(8, 3), padding=1)
        want = _partial_conv2d_plain(x, m, w, None, (8, 3), (1, 1), (1, 1), (1, 1))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- every plan over the scope ------------------------------------------------------------

def _cu_constexpr(src: str, name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", (CSRC / src).read_text())
    assert m, name
    return m.group(1).strip()


GEN_CONSTS = ("GEN_THREADS", "GEN_D", "GEN_TH", "GEN_R", "GEN_L", "GEN_RUN", "GM_TH", "GM_NPX",
              "GM_MT", "GM_RUN", "GW_TW")


@pytest.mark.parametrize("name", GEN_CONSTS)
def test_general_forms_tiles_match_the_source(name):
    """The general forms' tile and ring constants in ``gen_plan`` are the
    ``.cu``'s ``constexpr``s, and the plan's shared-memory formulas are the
    source's ``gen_*_smem`` terms: what the wrapper budgets is what the
    launcher asks for."""
    assert _cu_constexpr("partial_conv.cu", name) == str(getattr(kpc, name)), name
    src = (CSRC / "partial_conv.cu").read_text()
    assert "constexpr int GEN_TW = 32 * GEN_R;" in src and kpc.GEN_TW == 32 * kpc.GEN_R
    assert "constexpr int GM_ZS = GM_NPX + 8;" in src and kpc.GM_ZS == kpc.GM_NPX + 8
    assert ("return ((GEN_TH + GEN_D) * cbu * (GEN_TW + run) + (GEN_D + 1) * cbu * run * cout) "
            "* 16;") in src
    assert ("const int ring = ((GM_TH + GEN_D) * cbu * GM_NPX + (GEN_D + 1) * cbu * GM_MT * 16) "
            "* 16;") in src and "const int z = GM_TH * GM_MT * 16 * GM_ZS * 4;" in src
    assert ("return ((GEN_TH + GEN_D) * du * (GEN_TW + run) + (GEN_D + 1) * run * cout * 2) "
            "* 16;") in src
    assert ("const int ring = (1 + GEN_D) * (xun * (GW_TW + 1) + du * (GW_TW + rg * lw)) * 16;"
            in src) and "const int xun = scg;" in src
    assert "const int red = (npg - 1) * rg * scg * lw * cout * 16;" in src
    assert "return co <= 2 ? 8 : co <= 4 ? 4 : 2;" in src
    assert [kpc.gen_dw_taps(c) for c in range(1, 8)] == [8, 8, 4, 4, 2, 2, 2]


def _check_gen_plan(n, h, w, cin, cout, k, pad, g):
    """``gen_plan`` in both dtypes: within SMEM_LIMIT in every kernel, its
    dW partials within GEN_PART_FLOATS (or one row), segments covering every
    (row, strip) item once, blocks and runs the launchers accept."""
    items = n * h * -(-w // kpc.GW_TW)
    for elem in (2, 4):
        p = kpc.gen_plan(n, h, w, cin, cout, k, pad, g, elem)
        assert max(p.fwd_smem, p.dx_smem, p.dw_smem) <= kpc.SMEM_LIMIT, (elem, p)
        assert p.segs * k * k * cout * cin <= max(kpc.GEN_PART_FLOATS, k * k * cout * cin)
        assert (p.segs - 1) * p.rb < items <= p.segs * p.rb
        assert p.npg in (1, 2, 4, 8) and p.npg * p.rg * p.scg <= kpc.GEN_THREADS
        assert p.rg * kpc.gen_dw_taps(cout) >= min(k, 64 * kpc.gen_dw_taps(cout))
        if elem == 2:
            assert p.cbu >= 2 and p.cbu % 2 == 0 and 1 <= p.run <= kpc.GM_RUN
            assert p.run * cout <= kpc.GM_MT * 16 and p.run == min(k, kpc.GM_RUN, 48 // cout)
            assert p.dx_run % 2 == 0 and p.dx_run <= kpc.GX_RUN
        else:
            assert 1 <= p.cbu <= -(-cin // 4) and p.run % kpc.GEN_L == 0
            assert p.run <= kpc.GEN_RUN and p.dx_run % kpc.GEN_L == 0
        assert p.dx_run >= min(k, kpc.GX_RUN if elem == 2 else kpc.GEN_RUN)


@pytest.mark.parametrize("k", KS)
def test_small_cout_plans_return_over_the_scope(k):
    """K2 and K2F (Cout 1..7) and their backwards: a plan at every Cin, Cout,
    group count and padding (JAX's scope has no limit on any of them); the
    templated form only where its shared memory fits (``k2_smem_bytes``,
    ``k2f_smem_bytes``, ``k2f_bwd_smem_bytes``, held to the ``.cu``'s
    layout by test_torch_k2_plan.py and test_torch_f32_kernels.py), one or
    two groups and, for K2's backward, a padding up to k - 1, and below the
    routing cut (K2_GEN_K; K2F's backward at K2F_BWD_KS); the general forms' plan
    (``gen_plan``) everywhere, as ``_check_gen_plan`` holds it."""
    n, h, w = 2, 16, 40
    for cin in CINS:
        for cout in range(1, 8):
            k2 = kpc.k2_plan(cin, cout, k)
            assert k2.nblk * k2.cb >= cin and k2.kj >= k * k * cout
            for g in range(1, min(cin, 4) + 1):
                fwd = kpc.k2f_plan(n, h, w, cin, cout, k, (k // 2, (k - 1) // 2), g)
                if not fwd.general:
                    assert k in kpc.K2F_KS and g <= 2
                    assert kpc.k2f_smem_bytes(cin, cout, k) <= kpc.SMEM_LIMIT
                    assert 1 <= fwd.rb and fwd.tw == kpc.K2F_TW
                bwd = kpc.k2f_bwd_plan(n, h, w, cin, cout, k, g)
                if not bwd.general:
                    assert k in kpc.K2F_BWD_KS and g <= 2 and bwd.nseg * cin <= kpc.HB_THREADS
                    assert kpc.k2f_bwd_smem_bytes(cin, cout, k, bwd.nseg) <= kpc.SMEM_LIMIT
                for pad in ((0, 0), (k - 1, k - 1), (k, 1), (k + 3, 0)):
                    for backward in (False, True):
                        if kpc.k2_general(cin, cout, k, g, pad, backward):
                            continue
                        assert g <= 2 and (not backward or max(pad) <= k - 1)
                        assert k < kpc.K2_GEN_K
                        kj = k2.kj if backward else 0
                        assert kpc.k2_smem_bytes(k, k2.cb, kj) <= kpc.SMEM_LIMIT
                    if cin in (1, 67, 300, 1024):
                        _check_gen_plan(n, h, w, cin, cout, k, pad, g)


@pytest.mark.parametrize("k", range(16, 32))
def test_general_plan_returns_up_to_k_31(k):
    """Past KS, up to k 31: ``gen_plan`` at every Cin of CINS, Cout 1..7,
    one to four groups and the paddings above, and every form general."""
    n, h, w = 2, 16, 40
    for cin in CINS:
        for cout in range(1, 8):
            for g in range(1, min(cin, 4) + 1):
                assert kpc.k2f_plan(n, h, w, cin, cout, k, (k // 2, k // 2), g).general
                assert kpc.k2f_bwd_plan(n, h, w, cin, cout, k, g).general
                for pad in ((0, 0), (k - 1, k - 1), (k, 1)):
                    assert kpc.k2_general(cin, cout, k, g, pad)
                    assert kpc.k2_general(cin, cout, k, g, pad, True)
                    _check_gen_plan(n, h, w, cin, cout, k, pad, g)


@pytest.mark.parametrize("k", [1, 3, 5, 6, 7, 9, 10, 11, 13])
def test_routing_cut_at_the_head(k):
    """The routing cut at the head's 67 -> 3 (two groups, 'same' padding, 8
    pages of 512^2), as measured on the card (PERF.md): K2 and its backward
    templated below K2_GEN_K = 6, general from it; K2F's forward templated
    at every k it is built for; K2F's backward templated at k 1 and 3 only
    (K2F_BWD_KS). The U-Net's own head (k 3, padding 1) stays templated in
    both directions and both dtypes."""
    n, h, w, cin, cout, g, pad = 8, 512, 512, 67, 3, 2, ((k - 1) // 2, (k - 1) // 2)
    assert (kpc.K2_GEN_K, kpc.K2F_BWD_KS) == (6, (1, 3))
    assert kpc.k2_general(cin, cout, k, g, pad) == (k >= 6)
    assert kpc.k2_general(cin, cout, k, g, pad, True) == (k >= 6)
    assert kpc.k2f_plan(n, h, w, cin, cout, k, pad, g).general == (k not in (1, 3, 5, 7))
    assert kpc.k2f_bwd_plan(n, h, w, cin, cout, k, g).general == (k >= 5)
    if k == 3:
        assert not kpc.k2_general(cin, cout, 3, g, (1, 1))
        assert not kpc.k2_general(cin, cout, 3, g, (1, 1), True)
        assert not kpc.k2f_plan(n, h, w, cin, cout, 3, (1, 1), g).general
        assert not kpc.k2f_bwd_plan(n, h, w, cin, cout, 3, g).general


@pytest.mark.parametrize("k", KS)
def test_k1_plans_return_over_the_scope(k):
    """K1 and K1F (Cout >= 8) at every Cin and up to four groups: K1's
    layout puts each group on a multiple of 8 channels, its halo form only
    at one or two groups (the per-pixel bits it keeps), and K1F's split
    counts stay within its K steps."""
    n, h, w = 2, 16, 40
    for cin in CINS:
        for g in range(1, min(cin, 4) + 1):
            groups = _groups(cin, g)
            starts = kpc.k1_group_starts(groups)
            gb, cin_x, cin_p = kpc.k1_channels(groups)
            assert all(s % 8 == 0 for s in starts) and starts[-1] == cin_x and cin_p % 64 == 0
            assert all(starts[i + 1] - starts[i] >= size for i, size in enumerate(groups))
            table = kpc.group_table(groups)
            assert len(table) == 3 * g + 2 and table[g:2 * g + 1][-1] == cin
            for cout in (8, 16, 72, 256):
                plan = kpc.k1_plan(n, h, w, cout, cin_p, k, (k // 2, k // 2), g)
                assert not (plan.halo and g > 2)
                assert 1 <= plan.splits <= plan.steps(cin_p, k)
                f = kpc.k1f_plan(n, h, w, cin, cout, k, (k // 2, k // 2))
                assert 1 <= f.splits <= kpc.k1f_steps(cin, k)


def k6_gen_coverage(plan, n, h, w, k, d):
    """How often the general form's cut computes each (output pixel, tap)
    whose x lies inside the image, as two factors: rows (band x row group,
    the tap row skipped where its x row is outside) and columns (strip x
    segment x the walk's clamp, for the tile that owns the tap column; a
    window slot outside the image may be walked, it reads zeros). Returns
    the row counts (H, k), the in-image rows, the column counts (one (W, k)
    array for each size of row group: the units depend on the items) and
    the in-image columns."""
    hk = (k - 1) // 2
    kri, krj, kc, tj = plan.kri, plan.krj, plan.kc, plan.tj
    rows = np.zeros((h, k), np.int64)
    for band in range(plan.bands):
        h0 = band * plan.rows
        for rg in range(plan.ngr):
            ri0 = -kri + rg * plan.kg
            for ri in range(ri0, min(ri0 + plan.kg, kri + 1)):
                for oh in range(h0, min(h0 + plan.rows, h)):
                    if 0 <= oh + ri * d < h:
                        rows[oh, ri + hk] += 1
    kgcs = {min(plan.kg, kri + 1 - ri0) for ri0 in range(-kri, kri + 1, plan.kg)}
    cols = np.zeros((len(kgcs), w, k), np.int64)  # for each size of row group
    for strip, kgc in itertools.product(range(plan.strips), sorted(kgcs)):
        w0 = strip * plan.tw
        nw = min(plan.tw, w - w0)
        for ti in range(plan.ntj):
            st = min(ti * tj, kc - tj)
            ot = st - krj
            tg0 = ti // plan.ntg * plan.ntg  # its column group's first tile
            ni = kgc * min(plan.ntg, plan.ntj - tg0)
            _, seg, spc, units = kdw.k6_gen_units(ni, nw, d)
            for sg in range(units // kdw.K6_G):
                r, jc = sg // spc, (sg % spc) * seg
                ln = min(seg, -(-(nw - r) // d) - jc)
                ow0 = w0 + r + jc * d
                ja = max(0, -((ow0 + (ot + tj - 1) * d) // d))
                jb = min(ln, -(-(w - ow0 - ot * d) // d))
                for j in range(ja, jb):
                    for tt in range(tj):
                        cj = st + tt
                        x_col = ow0 + j * d + (cj - krj) * d
                        if cj >= ti * tj and 0 <= x_col < w:
                            cols[sorted(kgcs).index(kgc), ow0 + j * d, cj - krj + hk] += 1
    oh, o = np.arange(h)[:, None], np.arange(k)[None, :] - hk
    row_in = (oh + o * d >= 0) & (oh + o * d < h)
    ow = np.arange(w)[:, None]
    col_in = (ow + o * d >= 0) & (ow + o * d < w)
    return rows, row_in, cols, col_in


@pytest.mark.parametrize("k", range(1, 32, 2))
def test_k6_plans_return_over_the_scope(k):
    """K6 at every odd k up to 31 and dilations up to 5000 (JAX's depthwise
    ``supported``: any odd k, equal dilations): the templated form at k in
    K6_KERNEL_SIZES and a dilation its launcher takes, below the routing
    cut, while a strip with its halo fits one TMA row and the shared
    memory; else the general form, whose cut fits SMEM_LIMIT (the .cu's
    formula, ``k6_gen_smem``), keeps at most 64 (tap row, tile) items a
    CTA, and computes every (output pixel, tap) inside the image exactly
    once (the row and the column factors, ``k6_gen_coverage``)."""
    src = (CSRC / "depthwise_wgrad.cu").read_text()
    assert f"if (d > {kdw.K6_MAX_DILATION} ||" in src  # the templated launcher's limit
    for d in (1, 2, 3, 4, 8, 9, 16, 32, 48, 64, 5000):
        for c in (128, 200, 1024):
            for elem in (2, 4):
                for n, h, w in ((2, 64, 64), (1, 96, 300)):
                    plan = kdw.k6_plan(n, h, w, c, k, d, elem, SMS)
                    p = d * (k - 1) // 2
                    if not plan.general:
                        assert k in kdw.K6_KERNEL_SIZES and d <= kdw.K6_MAX_DILATION
                        assert p < kdw.K6_GEN_HALO
                        assert plan.tw + 2 * p <= kdw.K6_MAX_BOX and plan.smem <= kdw.SMEM_LIMIT
                        assert plan.smem == kdw.k6_smem_bytes(k, p, plan.tw, elem)
                        continue
                    g = plan.gen
                    assert g.smem == kdw.k6_gen_smem(h, w, k, d, g.tj, g.ntg, g.kg, g.tw, elem)
                    assert g.smem <= kdw.SMEM_LIMIT
                    assert 1 <= g.tj <= min(kdw.K6_GEN_TJ, g.kc) and g.ntj == -(-g.kc // g.tj)
                    assert g.kg * min(g.ntg, g.ntj) <= kdw.K6_GEN_NPX
                    assert g.cblocks == -(-c // kdw.K6_GEN_CH)
                    if c == 128:  # the cut does not depend on C beyond the blocks
                        rows, row_in, cols, col_in = k6_gen_coverage(g, n, h, w, k, d)
                        assert (rows[row_in] == 1).all() and (rows[~row_in] == 0).all()
                        assert (cols[:, col_in] == 1).all() and (cols[:, ~col_in] == 0).all()


def test_k6_general_chain_is_short():
    """The general form's longest chain of f32 adds into one dW value (a
    segment, the lane's segments, the tree over the item's lanes, the
    slots' blocks and the blocks) is under 167 = 1e-5 / 2^-24 at
    ``chip_smoke.py``'s SCOPE_K6 cases and at k 9 on the segmenter's block-2
    map, so ``check_wgrad``'s gate (1e-5 Σ|x·dy| of the f64 truth) holds by
    its own argument; recounted here from the plan's fields and the
    kernel's units."""
    from chip_smoke import SCOPE_K6

    cases = [(n, h, w, c, k, d) for _, n, h, w, c, k, d in SCOPE_K6] + [(8, 128, 128, 144, 9, 1)]
    for n, h, w, c, k, d in cases:
        for elem in (2, 4):
            g = kdw.k6_gen_plan(n, h, w, c, k, d, elem, SMS)
            steps = -(-g.rows // kdw.K6_G)
            worst = 0
            for kgc in {min(g.kg, 2 * g.kri + 1 - i) for i in range(0, 2 * g.kri + 1, g.kg)}:
                for ntc in {min(g.ntg, g.ntj - i) for i in range(0, g.ntj, g.ntg)}:
                    ni = kgc * ntc
                    lpi, seg, _, units = kdw.k6_gen_units(ni, g.tw, d)
                    tree = int(np.ceil(np.log2(-(-kdw.K6_GEN_NPX // ni)))) if ni < 64 else 0
                    worst = max(worst, seg + steps * -(-units // lpi) + tree)
            slots = g.slots(n)
            chain = worst + g.fold + -(-slots // g.fold)
            assert chain == g.chain < 167, (n, h, w, c, k, d, elem, g)


# -- the general forms, emulated --------------------------------------------------------

def _units(t: torch.Tensor, v: int) -> torch.Tensor:
    """(N, H, W, C) -> ``pconv_gen_relay``'s units (N, H, ceil(C / v), W, v),
    0 past C."""
    n, h, w, c = t.shape
    u = -(-c // v)
    return F.pad(t, (0, u * v - c)).reshape(n, h, w, u, v).permute(0, 1, 3, 2, 4)


def _gen_msum(m, groups, k, pad):
    """``pconv_gen_rowsum``, then the forward's sum of k row sums: sum over
    dy of (sum over dx of sum_g size_g M_g), each in order, in f32."""
    n, h, w, g = m.shape
    ph, pw = pad
    hout, wout = h + 2 * ph - k + 1, w + 2 * pw - k + 1
    s = torch.zeros((n, h, w))
    for gi, size in enumerate(groups):
        s = s + float(size) * m[..., gi]
    sp = F.pad(s, (pw, pw, ph, ph))
    rows = torch.zeros((n, h + 2 * ph, wout))
    for dx in range(k):
        rows = rows + sp[:, :, dx:dx + wout]
    msum = torch.zeros((n, hout, wout))
    for dy in range(k):
        msum = msum + rows[:, dy:dy + hout]
    return msum.unsqueeze(-1)


def _epilogue(acc, msum, b, kkc):
    valid = msum > 0
    y = acc * (kkc / msum.clamp(min=1.0)) + b
    return torch.where(valid, y, torch.zeros(())), valid.float()


def emulate_gen_fwd_bf16(x, m, w, b, groups, pad):
    """``pconv_gen_fwd_bf16`` in torch f32, tile by tile as the kernel walks
    it: a CTA's row of GM_NPX input columns from ow0 - pw + dx0 (ow0 = CTA
    x tw, tw = GM_NPX - run + 1), Z[(dx - dx0, o)][q] summed over blocks of
    units, tap rows and channels from ``gen_fwd_weights``'s layout, then
    y[p][o] += sum over the run's taps of Z[dx, o][p + dx], runs in order;
    msum from the row sums; K2's epilogue. Zero-filled outside the image."""
    n, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    ph, pw = pad
    hout, wout = h + 2 * ph - k + 1, wd + 2 * pw - k + 1
    plan = kpc.gen_plan(n, h, wd, cin, cout, k, pad, len(groups), 2)
    L, cbu = plan.run, plan.cbu
    assert plan.fwd_smem <= kpc.SMEM_LIMIT and L * cout <= kpc.GM_MT * 16 and cbu % 2 == 0
    wk = kpc.gen_fwd_weights(w, 2, L).float()  # (k, xu, k, cout, 8)
    xu = wk.shape[1]
    xm = _units(apply_mask(x, m, groups), 8)  # (n, h, xu, w, 8)
    tw = kpc.GM_NPX - L + 1
    y = torch.zeros((n, hout, wout, cout))
    xu2 = -(-xu // 2) * 2
    for ow0 in range(0, wout, tw):
        cols = min(tw, wout - ow0)
        for dx0 in range(0, k, L):
            rl = min(L, k - dx0)
            z = torch.zeros((n, hout, rl, cout, kpc.GM_NPX))
            for b0 in range(0, xu2, cbu):
                for dy in range(k):
                    oh0, oh1 = max(0, ph - dy), min(hout, h + ph - dy)
                    q0, q1 = max(0, pw - ow0 - dx0), min(kpc.GM_NPX, wd + pw - ow0 - dx0)
                    if oh0 >= oh1 or q0 >= q1:
                        continue
                    iw0 = ow0 - pw + dx0 + q0
                    for u in range(b0, min(b0 + cbu, xu)):
                        xs = xm[:, oh0 + dy - ph:oh1 + dy - ph, u, iw0:iw0 + q1 - q0]
                        z[:, oh0:oh1, :, :, q0:q1] += torch.einsum(
                            "nhqc,loc->nhloq", xs, wk[dy, u, dx0:dx0 + rl])
            for dl in range(rl):
                y[:, :, ow0:ow0 + cols] += z[:, :, dl, :, dl:dl + cols].permute(0, 1, 3, 2)
    return _epilogue(y, _gen_msum(m, groups, k, pad), b, float(k * k * cin))


def emulate_gen_fwd_f32(x, m, w, b, groups, pad):
    """``pconv_gen_fwd_f32`` in torch f32: the sums in its order, runs of
    taps, blocks of 4-channel units, tap rows, units, taps (windows of GEN_L
    taps), then the unit's 4 channels, the weights read from
    ``gen_fwd_weights``'s layout (zero past k); msum and the epilogue as the
    bf16 form."""
    n, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    ph, pw = pad
    hout, wout = h + 2 * ph - k + 1, wd + 2 * pw - k + 1
    plan = kpc.gen_plan(n, h, wd, cin, cout, k, pad, len(groups), 4)
    run, cbu = plan.run, plan.cbu
    assert plan.fwd_smem <= kpc.SMEM_LIMIT and run % kpc.GEN_L == 0
    wk = kpc.gen_fwd_weights(w, 4, run)  # (k, xu, runs * run, cout, 4)
    xu = wk.shape[1]
    xm = F.pad(_units(apply_mask(x, m, groups), 4), (0, 0, pw, pw + run, 0, 0, ph, ph))
    acc = torch.zeros((n, hout, wout, cout))
    for dx0 in range(0, k, run):
        rl = -(-min(run, k - dx0) // kpc.GEN_L) * kpc.GEN_L
        for b0 in range(0, xu, cbu):
            for dy in range(k):
                for u in range(b0, min(b0 + cbu, xu)):
                    for dl in range(rl):
                        dx = dx0 + dl
                        win = xm[:, dy:dy + hout, u, dx:dx + wout]  # (n, hout, wout, 4)
                        wv = wk[dy, u, dx]  # (cout, 4)
                        for e in range(4):
                            acc = acc + win[..., e:e + 1] * wv[:, e]
    return _epilogue(acc, _gen_msum(m, groups, k, pad), b, float(k * k * cin))


def emulate_gen_bwd(g, x, m, w, groups, pad, rb=None, elem=4):
    """``pconv_gen_dx_f32`` and ``pconv_gen_dw_f32`` (elem 4) or their bf16 forms
    ``pconv_gen_dx_bf16`` and ``pconv_gen_dw_bf16`` (elem 2; computed here
    in f32) after ``pconv_k3_prep``, in torch, as the kernels index them:
    dacc = g * scale where the window has a valid tap. dx: per run of
    ``dx_run`` taps, steps j (tap row k - 1 - j), the reversed taps r (dx =
    run * run + run - 1 - r, weights from ``gen_dx_weights``; in pairs for
    bf16), rounded once, times the group mask. dW: segments of ``rb`` (row,
    64-column strip) items over all images; per item the dacc window at the
    kernel's slot column (from oc0 = iw0 + pw - (first tap past the CTA's) + 1);
    the pixel groups added in order, the segments as ``pconv_colsum`` adds
    them (rows y, y + 8, ... then the 8 sums in order)."""
    n, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    ph, pw = pad
    hout, wout = g.shape[1:3]
    plan = kpc.gen_plan(n, h, wd, cin, cout, k, pad, len(groups), elem)
    assert plan.dx_smem <= kpc.SMEM_LIMIT and plan.dw_smem <= kpc.SMEM_LIMIT
    msum = mask_window_sum(m, groups, (k, k), stride=(1, 1), padding=pad)
    dacc = torch.where(msum > 0, g * (float(k * k * cin) / msum.clamp(min=1.0)), 0.0)
    # dx
    run = plan.dx_run
    nrun = -(-k // run)
    wk = kpc.gen_dx_weights(w, run, elem)
    if elem == 2:  # (k, ncb, nrun * run, GX_CB, 8) -> the f32 form's (..., o, c) order
        wk = wk.reshape(k, -1, nrun * run, kpc.GX_CB // 8, 8, 8).permute(0, 1, 3, 2, 5, 4)
        wk = wk.reshape(k, -1, nrun * run, 8, 8)[..., :cout, :]
    nct = wk.shape[1]
    big = k + nrun * run + max(h, wd) + max(ph, pw)
    dpad = F.pad(dacc, (0, 0, big, big, big, big))  # dacc (oh, ow) at (oh + big, ow + big)
    dxm = torch.zeros((n, h, wd, nct * 8))
    for rho in range(nrun):
        for j in range(k):
            dy = k - 1 - j
            for r in range(run):
                dx = rho * run + run - 1 - r  # dacc row ih + ph - dy, column iw + pw - dx
                win = dpad[:, big + ph - dy:big + ph - dy + h, big + pw - dx:big + pw - dx + wd]
                for o in range(cout):
                    dxm = dxm + win[..., o:o + 1] * wk[dy, :, rho * run + r, o].reshape(-1)
    dx = apply_mask(dxm[..., :cin], m, groups)
    # dW
    items, strips = n * h * -(-wd // kpc.GW_TW), -(-wd // kpc.GW_TW)
    rb = plan.rb if rb is None else rb
    segs = -(-items // rb)
    if elem == 2:  # tap pairs, GD_PAIRS a CTA; pixel groups of k16 steps
        pairs = -(-k // 2)
        span = [(p0, min(kpc.GD_PAIRS, pairs - p0)) for p0 in range(0, pairs, kpc.GD_PAIRS)]
    else:  # runs of LW taps, all in one CTA (rg >= runs here)
        lw = kpc.gen_dw_taps(cout)
        assert plan.rg >= -(-k // lw)
        span = [(0, -(-k // lw))]
    xm = F.pad(apply_mask(x, m, groups), (0, 0, 0, kpc.GW_TW))
    pad_w = kpc.GW_TW + 2 * k + 16
    dwide = F.pad(dacc, (0, 0, pad_w, pad_w))  # dacc column col at pad_w + col
    rows_out = []
    for seg in range(segs):
        part = torch.zeros((k, k, cout, cin))
        for dy in range(k):
            for p0, npr in span:
                if elem == 2:
                    npg, width = kpc.GEN_THREADS // 32 // npr, 2
                    taps_end = 2 * (p0 + npr)
                else:
                    npg, width = plan.npg, kpc.gen_dw_taps(cout)
                    taps_end = width * (p0 + npr)
                accs = [torch.zeros((taps_end, cout, cin)) for _ in range(npg)]
                for r in range(seg * rb, min(seg * rb + rb, items)):
                    row, iw0 = divmod(r, strips)
                    iw0 *= kpc.GW_TW
                    nn, ih = divmod(row, h)
                    oh = ih + ph - dy
                    if not 0 <= oh < hout:
                        continue
                    oc0 = iw0 + pw - taps_end + 1  # dacc column of slot column 0
                    for pg in range(npg):
                        if elem == 2:
                            qs = [q for ks in range(pg, kpc.GW_TW // 16, npg)
                                  if iw0 + ks * 16 < wd for q in range(ks * 16, ks * 16 + 16)]
                        else:
                            gw = kpc.GW_TW // npg
                            qs = [q for q in range(pg * gw, pg * gw + gw)
                                  if iw0 + q - q % width < wd]
                        for tap in range(2 * p0 if elem == 2 else width * p0, taps_end):
                            base = (taps_end - 1 - tap) if elem == 2 else None
                            for q in qs:
                                if elem == 2:
                                    col = oc0 + q + base  # tapoff - (tap - dxa)
                                else:
                                    rho = tap // width
                                    off = (p0 + npr - rho) * width - 1
                                    col = oc0 + (q - q % width) + off + q % width - tap % width
                                d = dwide[nn, oh, pad_w + col]
                                accs[pg][tap] += d[:, None] * xm[nn, ih, iw0 + q]
                total = accs[0]
                for a in accs[1:]:
                    total = total + a
                lo = 2 * p0 if elem == 2 else kpc.gen_dw_taps(cout) * p0
                hi = min(k, taps_end)
                part[dy, lo:hi] = total[lo:hi]
        rows_out.append(part)
    sums = [sum(rows_out[y::8], torch.zeros_like(rows_out[0])) for y in range(min(8, segs))]
    dw = sums[0]
    for t in sums[1:]:
        dw = dw + t
    return dx, dw.permute(2, 3, 0, 1)


GEN_CASES = [  # groups, cout, k, padding
    ((5, 6), 3, 2, (1, 0)),             # even k, unequal padding
    ((3, 3, 2), 3, 3, (1, 1)),           # three groups
    ((24, 16, 8), 2, 3, (4, 1)),         # three groups, padding above k - 1
    ((40,), 1, 5, (2, 2)),               # one group, Cout 1
    ((150, 50), 5, 4, (1, 2)),           # Cin 200: several blocks of units
    ((9, 4), 7, 4, (3, 2)),              # even k 4, padding k - 1 and above; Cout 7
    ((64, 3), 3, 11, (5, 5)),            # the head's channels at k 11
    ((64, 3), 3, 13, (6, 6)),            # and at k 13
    ((9, 4), 7, 9, (4, 4)),              # Cout 7 at k 9: two mma runs of 6 and 3 taps
]


@pytest.mark.parametrize("groups,cout,k,pad", GEN_CASES,
                         ids=["-".join(map(str, (*c[0], c[1], c[2], *c[3]))) for c in GEN_CASES])
def test_general_forms_emulated_match_jax_vjp(groups, cout, k, pad):
    """The general forms emulated in their own tiling and order (both
    forwards, dx, and dW with the plan's segments and with segments of 3
    items) against ``jax.vjp`` of JAX's ``_partial_conv2d_xla``; M' exact."""
    rng = np.random.default_rng(sum(groups) * 7 + k)
    cin = sum(groups)
    x = rng.standard_normal((2, 7, 9, cin)).astype(np.float32)
    m = (rng.random((2, 7, 9, len(groups))) < 0.6).astype(np.float32)
    m[0, :k + 1, :k + 1] = 0
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal((cout,))).astype(np.float32)

    def jax_fn(x, w, b):
        return jpc._partial_conv2d_xla(x, jnp.asarray(m), w, b, groups, (1, 1), pad, (1, 1))

    (want_y, want_m), vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    g = rng.standard_normal(want_y.shape).astype(np.float32)
    want_dx, want_dw, _ = vjp((jnp.asarray(g), jnp.zeros_like(want_m)))
    tx, tm = torch.from_numpy(x), torch.from_numpy(m)
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    for emulate in (emulate_gen_fwd_bf16, emulate_gen_fwd_f32):
        y, nm = emulate(tx, tm, tw, torch.from_numpy(b), groups, pad)
        np.testing.assert_array_equal(nm.numpy(), np.asarray(want_m), err_msg=emulate.__name__)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL,
                                   err_msg=emulate.__name__)
    for elem, rb in ((4, None), (4, 3), (2, None), (2, 3)):
        dx, dw = emulate_gen_bwd(torch.from_numpy(g), tx, tm, tw, groups, pad, rb, elem)
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=RTOL, atol=ATOL,
                                   err_msg=f"dx, elem {elem}")
        np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw).transpose(3, 2, 0, 1),
                                   rtol=RTOL, atol=ATOL, err_msg=f"dW, elem {elem}, rb {rb}")


def emulate_k6_gen(x, dy, k, d, plan):
    """K6's general form as ``plan`` (a ``K6GenPlan``) cuts the call, in
    torch f32, every channel block at once (the blocks are independent):
    for each CTA, its x ring filled a step ahead with the rows the kernel
    stages (the image's own columns of the rows some tap row of the group
    uses; NaN elsewhere, so that a wrong ring row or column fails), each
    pixel lane's item (tap row, tile of tj tap columns) walking its units
    (row of the step, segment of a residue class) over the columns at which
    some slot of the tile reaches the image, window slots outside it reading
    zeros, a segment summed in order into a fresh sum and that into the
    lane's total; the pairwise tree over an item's lanes; each CTA's slot
    of owned taps; ``dw_wgrad_gen_fold``'s blocks of slots, in order, +0 for
    taps outside the image."""
    n, h, w, c = x.shape
    g_rows, pre, npx = kdw.K6_G, kdw.K6_PRE, kdw.K6_GEN_NPX
    kri, krj, tj, ntj, ntg, kg = plan.kri, plan.krj, plan.tj, plan.ntj, plan.ntg, plan.kg
    kc, ntap = plan.kc, plan.ntap
    nxr = (kg - 1) * d + g_rows * (pre + 1)
    ngr_rows = g_rows * (pre + 1)
    slots = plan.slots(n)
    part = torch.full((slots, ntap, c), float("nan"))

    def tile_start(ti):
        return min(ti * tj, kc - tj)

    for slot in range(slots):
        strip, nb = slot % plan.strips, slot // plan.strips
        img, band = divmod(nb, plan.bands)
        h0, w0 = band * plan.rows, strip * plan.tw
        nrows, nw = min(plan.rows, h - h0), min(plan.tw, w - w0)
        steps = -(-nrows // g_rows)
        for z in range(plan.ngr * plan.ngc):
            rg, cg = z % plan.ngr, z // plan.ngr
            ri0 = -kri + rg * kg
            kgc = min(kg, kri + 1 - ri0)
            tg0 = cg * ntg
            ntc = min(ntg, ntj - tg0)
            span, xr0 = (kgc - 1) * d, h0 + ri0 * d
            xc0 = max(0, w0 + (tile_start(tg0) - krj) * d)
            xc1 = min(w, w0 + nw - 1 + (tile_start(tg0 + ntc - 1) + tj - 1 - krj) * d + 1)
            nxc = max(0, xc1 - xc0)
            xring = torch.full((nxr, max(nxc, 1), c), float("nan"))
            gring = torch.full((ngr_rows, nw, c), float("nan"))

            def wanted(r):
                if not 0 <= xr0 + r < h:
                    return False
                return r - min(kgc - 1, r // d) * d < nrows

            def issue(s):
                if s >= steps:
                    return
                j0, j1 = s * g_rows, min(s * g_rows + g_rows, nrows)
                lo, hi = (0 if s == 0 else j0 + span), j1 - 1 + span
                for r in range(lo, hi + 1):
                    if wanted(r):
                        xring[r % nxr, :nxc] = x[img, xr0 + r, xc0:xc1]
                for j in range(j0, j1):
                    gring[j % ngr_rows] = dy[img, h0 + j, w0: w0 + nw]

            ni = kgc * ntc
            _, seg, spc, units = kdw.k6_gen_units(ni, nw, d)
            nseg = units // g_rows
            tot = torch.zeros((npx, tj, c))
            for s in range(pre):
                issue(s)
            for s in range(steps):
                issue(s + pre)  # before the sums, as the kernel may
                for pl in range(npx):
                    item, sub = pl % ni, pl // ni
                    lpi = (npx - item + ni - 1) // ni
                    ri, ti = ri0 + item // ntc, tg0 + item % ntc
                    ot = tile_start(ti) - krj
                    for u in range(sub, units, lpi):
                        gg, sg = divmod(u, nseg)
                        ro = s * g_rows + gg
                        if ro >= nrows:
                            break
                        if not 0 <= h0 + ro + ri * d < h:
                            continue
                        r, jc = sg // spc, (sg % spc) * seg
                        ln = min(seg, -(-(nw - r) // d) - jc)
                        ow0 = w0 + r + jc * d
                        ja = max(0, -((ow0 + (ot + tj - 1) * d) // d))
                        jb = min(ln, -(-(w - ow0 - ot * d) // d))
                        if ja >= jb:
                            continue
                        xrow = xring[(ro + (ri - ri0) * d) % nxr]
                        # x of slot t at step j: column ow0 + (j + ot + t) d, zero outside
                        cols = ow0 + (torch.arange(ja, jb)[:, None] + ot
                                      + torch.arange(tj)[None, :]) * d
                        inside = (cols >= 0) & (cols < w)
                        win = torch.where(inside[..., None],
                                          xrow[(cols - xc0).clamp(0, max(nxc, 1) - 1)], 0.0)
                        gv = gring[ro % ngr_rows][(ow0 - w0 + torch.arange(ja, jb) * d)]
                        prods = win * gv[:, None, :]
                        acc = torch.zeros((tj, c))
                        for j in range(jb - ja):
                            acc = acc + prods[j]
                        tot[pl] = tot[pl] + acc
            # the pairwise tree over each item's lanes
            red = tot.clone()
            st = 1
            while st < -(-npx // ni):
                for pl in range(npx):
                    if (pl // ni) % (2 * st) == 0 and pl + st * ni < npx:
                        red[pl] = red[pl] + red[pl + st * ni]
                st *= 2
            for item in range(ni):
                ti = tg0 + item % ntc
                for tt in range(tj):
                    cj = tile_start(ti) + tt
                    if cj >= ti * tj:
                        part[slot, (ri0 + item // ntc + kri) * kc + cj] = red[item, tt]
    dw = torch.zeros((k * k, c))
    hk = (k - 1) // 2
    for tap in range(k * k):
        oi, oj = tap // k - hk, tap % k - hk
        if abs(oi) > kri or abs(oj) > krj:
            continue  # +0: the tap never reaches the image
        tv = (oi + kri) * kc + oj + krj
        total = torch.zeros(c)
        for b0 in range(0, slots, plan.fold):
            blk = torch.zeros(c)
            for sl in range(b0, min(b0 + plan.fold, slots)):
                blk = blk + part[sl, tv]
            total = total + blk
        dw[tap] = total
    return dw.reshape(k, k, 1, c)


def _jax_depthwise_wgrad(x, dy, k, d):
    c = x.shape[-1]
    p = d * (k - 1) // 2
    kern = jnp.zeros((k, k, 1, c), jnp.float32)
    _, vjp = jax.vjp(lambda kk: jconv2d(jnp.asarray(x), kk, stride=1, padding=p, dilation=d,
                                        groups=c), kern)
    return np.asarray(vjp(jnp.asarray(dy))[0])


def _k6_gen_check(n, h, w, c, k, d, elem, forced=None):
    """The emulated general form (``k6_gen_plan``'s cut, or ``forced``
    fields) and the plain version against ``jax.vjp`` of JAX's depthwise
    conv, within 1e-4 (relative and absolute) and the emulation also within
    1e-5 of max |dW| (bf16 inputs rounded first: their products are exact
    in f32)."""
    rng = np.random.default_rng(n * h * w + c + 7 * k + d)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    dy = rng.standard_normal((n, h, w, c)).astype(np.float32)
    if elem == 2:
        x, dy = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (x, dy))
    plan = kdw.k6_gen_plan(n, h, w, c, k, d, elem, SMS)
    if forced:
        plan = plan._replace(**forced)
        plan = plan._replace(ntj=-(-plan.kc // plan.tj), bands=-(-h // plan.rows),
                             strips=-(-w // plan.tw))
    want = _jax_depthwise_wgrad(x, dy, k, d)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    got = emulate_k6_gen(tx, tdy, k, d, plan)
    scale = np.abs(want).max()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    # taps that never reach the image are +0, not -0
    kri, krj = kdw.k6_tap_radii(h, w, k, d)
    hk = (k - 1) // 2
    off = np.abs(np.arange(k) - hk)
    outside = (off[:, None] > kri) | (off[None, :] > krj)
    assert not np.signbit(got.numpy()[outside]).any()
    plain = kdw.depthwise_wgrad(tx, tdy, k, d)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,d", [(9, 1), (7, 3), (3, 9), (11, 2)])
def test_k6_general_form_and_plain_match_jax_vjp(k, d):
    """K6's general form (emulated in its own cut) and its plain version,
    at windows the templated form is not built for and a dilation whose
    halo is wider than the page, against ``jax.vjp`` of JAX's depthwise
    conv."""
    _k6_gen_check(2, 12, 13, 8, k, d, 4)


# (N, H, W, C, k, d, elem): k 9 to 15, d 1 to 48, C 130 (260 bytes a bf16
# pixel) and 200, ragged maps
K6_GEN_CASES = [
    (2, 12, 13, 130, 9, 1, 2),
    (2, 17, 14, 200, 9, 2, 4),
    (2, 24, 19, 130, 11, 3, 2),
    (2, 13, 22, 200, 11, 1, 4),
    (2, 20, 21, 130, 13, 2, 2),
    (2, 23, 12, 200, 13, 9, 4),
    (2, 19, 24, 200, 15, 1, 2),
    (2, 24, 17, 130, 15, 48, 4),  # only the centre tap reaches the image
    (2, 14, 15, 200, 9, 48, 2),
    (2, 21, 18, 130, 15, 3, 4),
    (2, 16, 23, 200, 11, 9, 2),
    (2, 22, 13, 130, 13, 1, 4),
]


@pytest.mark.parametrize("n,h,w,c,k,d,elem", K6_GEN_CASES,
                         ids=[f"{h}x{w}-C{c}-k{k}-d{d}-e{e}"
                              for n, h, w, c, k, d, e in K6_GEN_CASES])
def test_k6_general_walk_matches_jax(n, h, w, c, k, d, elem):
    _k6_gen_check(n, h, w, c, k, d, elem)


# cuts the plan does not take at these sizes: column strips, tiles narrower
# than the row (column groups of one tile, tj 1 to 4), tap rows in groups
# whose x rows leave gaps (d > G), a short last row group and band
K6_GEN_FORCED = [
    (2, 15, 22, 130, 9, 1, 2, dict(tj=3, ntg=1, kg=2, rows=6, tw=9)),
    (2, 15, 22, 130, 9, 1, 4, dict(tj=5, ntg=2, kg=9, rows=15, tw=22)),
    (1, 19, 17, 40, 9, 6, 2, dict(tj=1, ntg=3, kg=2, rows=7, tw=17)),
    (1, 21, 20, 24, 11, 2, 4, dict(tj=4, ntg=2, kg=4, rows=9, tw=7)),
    (1, 13, 16, 20, 13, 1, 2, dict(tj=2, ntg=7, kg=5, rows=13, tw=16)),
]


@pytest.mark.parametrize("n,h,w,c,k,d,elem,forced", K6_GEN_FORCED,
                         ids=[f"k{e[4]}-d{e[5]}-" + "-".join(f"{a}{v}" for a, v in e[7].items())
                              for e in K6_GEN_FORCED])
def test_k6_general_walk_forced_cuts(n, h, w, c, k, d, elem, forced):
    _k6_gen_check(n, h, w, c, k, d, elem, forced)


# -- the port against JAX's Pallas kernels at the new shapes --------------------------------

PALLAS_CASES = [  # groups, cout, k
    ((197, 3), 3, 3),
    ((64, 3), 3, 2),
    ((64, 3), 3, 9),
    ((3, 3, 2), 3, 3),
    ((24, 16, 8), 16, 3),
    ((24, 16, 8), 3, 3),
]


@pytest.mark.parametrize("groups,cout,k", PALLAS_CASES,
                         ids=["-".join(map(str, (*c[0], c[1], c[2]))) for c in PALLAS_CASES])
def test_f32_matches_jax_pallas_at_the_new_shapes(groups, cout, k):
    """The port's ``partial_conv2d`` (the kernels' plain version on the CPU)
    and its gradients against JAX's ``impl='pallas'`` in interpret mode and
    its custom VJP, in f32 at an output height under 8 (inside the scope),
    M' exact."""
    rng = np.random.default_rng(sum(groups) + 13 * k + cout)
    cin = sum(groups)
    pad = (k // 2, k // 2)
    x = rng.standard_normal((1, 6, 7, cin)).astype(np.float32)
    m = (rng.random((1, 6, 7, len(groups))) < 0.6).astype(np.float32)
    m[0, :3, :3] = 0
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal((cout,))).astype(np.float32)

    def jax_fn(x, w, b):
        return jpc.partial_conv2d(x, jnp.asarray(m), w, b, group_sizes=groups, padding=pad,
                                  impl="pallas")

    (want_y, want_m), vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert want_y.shape[1] < 8
    g = rng.standard_normal(want_y.shape).astype(np.float32)
    want = vjp((jnp.asarray(g), jnp.zeros_like(want_m)))
    leaves = [torch.from_numpy(x).requires_grad_(True),
              torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True),
              torch.from_numpy(b).requires_grad_(True)]
    y, nm = partial_conv2d(leaves[0], torch.from_numpy(m), leaves[1], leaves[2],
                           group_sizes=groups, padding=pad)
    np.testing.assert_array_equal(nm.detach().numpy(), np.asarray(want_m))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    for what, a, r in zip(("dx", "dW", "db"), got, want):
        r = np.asarray(r)
        if what == "dW":
            r = r.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(a.numpy(), r, rtol=RTOL, atol=ATOL, err_msg=what)
