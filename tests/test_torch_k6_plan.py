"""K6's geometry on the CPU: the plan, the shared-memory budget, and a torch
emulation of what csrc/depthwise_wgrad.cu does with them.

The kernel runs only on the card; what it computes is fixed by a few
constants, the plan (``k6_plan``) and its index arithmetic. These tests
take the constants from the CUDA source itself (every namespace-scope
``constexpr int``, evaluated in order) and hold:

  * the plan at the segmenter's five shapes and at ``K6_RAGGED``: its
    channel block, bands and strips, and that its CTAs cover every (image,
    row, column, channel) exactly once;
  * the lanes' segments of a row (residue classes mod d) cover every
    column exactly once;
  * each plan's shared memory within the block limit, by the kernel's own
    formula, and one TMA row within the 256-pixel box;
  * an emulation, in f32 torch, of each CTA's walk: the x and dy rings
    filled a step ahead with TMA's zero fill (rows the walk never fills
    hold NaN, so a wrong ring index fails), the sliding k x k window of
    each lane's segment, the lanes' butterfly, the warps' and the slots'
    fixed-order sums. It must equal ``depthwise_wgrad_reference`` and
    JAX's XLA VJP of the depthwise conv within 1e-5 of max |ref|;
  * the general form's constants, template instances and shared memory
    against the ``.cu``, its cut at a dilation no strip can take, and the
    routing cut (``K6_GEN_HALO``) that keeps the models' shapes templated.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K6_RAGGED, SEG_SHAPES
from text_segmentation_image_inpainting_tpu.ops.conv import conv2d as jconv2d
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
from tests.test_torch_bridge import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


CU = Path(kdw.__file__).resolve().parents[2] / "csrc" / "depthwise_wgrad.cu"
SMS = 132  # an H100 SXM


def cu_constants() -> dict:
    """Every namespace-scope ``constexpr int`` of csrc/depthwise_wgrad.cu,
    evaluated in order with C's integer division."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = (.*?);", CU.read_text(), flags=re.M):
        env[name] = eval(re.sub(r"(?<![/])/(?![/])", "//", expr), {}, env)
    return env


K = cu_constants()


def cdiv(a, b):
    return -(-a // b)


def test_constants_match_the_kernel():
    assert (K["NT"], K["G"], K["PRE"], K["MIN_CTAS"], K["MAX_BOX"], K["ALIGN"], K["PB"],
            K["MAX_SMEM"]) == (kdw.K6_THREADS, kdw.K6_G, kdw.K6_PRE, kdw.K6_MIN_CTAS,
                               kdw.K6_MAX_BOX, kdw.K6_ALIGN, kdw.K6_PIXEL_BYTES, kdw.SMEM_LIMIT)
    assert K["NBAR"] == K["PRE"] + 1 and K["NWARPS"] == K["NT"] // 32
    # channels per lane, as cpt<K>() has them
    m = re.search(r"constexpr int cpt\(\) \{ return K <= 3 \? (\d+) : K == 5 \? (\d+) : (\d+); \}",
                  CU.read_text())
    assert m and tuple(map(int, m.groups())) == (kdw.k6_cpt(3), kdw.k6_cpt(5), kdw.k6_cpt(7))


def smem_bytes(k, p, tw, elem):
    """The kernel's smem_bytes, from its constants."""
    up = lambda b: cdiv(b, K["ALIGN"]) * K["ALIGN"]  # noqa: E731
    rows, pb = K["G"] * (K["PRE"] + 1), K["PB"]
    ring = (2 * p + rows) * up((tw + 2 * p) * pb) + rows * up(tw * pb)
    return K["ALIGN"] + max(ring, K["NWARPS"] * k * k * (pb // elem) * 4)


def _cases():
    seg = [(name, 8, h, h, c, 3, d, 2) for name, h, c, d, _ in SEG_SHAPES]
    ragged = [(name, n, h, w, c, k, d, 4 if dt == torch.float32 else 2)
              for name, n, h, w, c, k, d, dt in K6_RAGGED]
    return seg + ragged


CASES = _cases()


@pytest.mark.parametrize("name,n,h,w,c,k,d,elem", CASES, ids=[c[0] for c in CASES])
def test_plan_fits_and_covers_every_element_once(name, n, h, w, c, k, d, elem):
    plan = kdw.k6_plan(n, h, w, c, k, d, elem, SMS)
    p = d * (k - 1) // 2
    assert plan.cb_ch == K["PB"] // elem
    assert plan.smem == kdw.k6_smem_bytes(k, p, plan.tw, elem) == smem_bytes(
        k, p, plan.tw, elem) <= K["MAX_SMEM"]
    assert plan.tw + 2 * p <= K["MAX_BOX"]
    # lanes of one pixel share a warp; every row of a step has its lanes
    tpc = plan.cb_ch // kdw.k6_cpt(k)
    assert tpc <= 32 and (K["NT"] // tpc) % K["G"] == 0
    count = np.zeros((n, h, w, plan.cblocks * plan.cb_ch), np.int32)
    for cb in range(plan.cblocks):
        for slot in range(plan.slots(n)):
            strip, nb = slot % plan.strips, slot // plan.strips
            img, band = divmod(nb, plan.bands)
            h0, w0, c0 = band * plan.rows, strip * plan.tw, cb * plan.cb_ch
            count[img, h0: h0 + plan.rows, w0: w0 + plan.tw, c0: c0 + plan.cb_ch] += 1
    assert (count[..., :c] == 1).all()


def test_plan_at_the_segmenters_shapes():
    """One H100's cut of the five layers (bands, rows), whole rows."""
    want = {"block 2": (3, 43), "blocks 4-6": (5, 13), "blocks 7-10": (4, 16),
            "blocks 11-13": (4, 16), "blocks 14-16": (1, 64)}
    for name, h, c, d, _ in SEG_SHAPES:
        plan = kdw.k6_plan(8, h, h, c, 3, d, 2, SMS)
        assert (plan.strips, plan.tw) == (1, h)
        assert (plan.bands, plan.rows) == want[name], name


def test_plan_cases_reach_the_partial_wave_and_the_strips():
    """K6_RAGGED holds a plan with more CTAs than fit on the card at once and
    a partial last wave, and one whose rows are cut into column strips."""
    slots = K["MIN_CTAS"] * SMS
    ctas = {name: kdw.k6_plan(n, h, w, c, k, d, 4 if dt == torch.float32 else 2, SMS)
            for name, n, h, w, c, k, d, dt in K6_RAGGED}
    grids = {name: pl.slots(n) * pl.cblocks for (name, n, *_), pl in
             zip(K6_RAGGED, ctas.values())}
    assert any(g > slots and g % slots for g in grids.values())
    assert any(pl.strips > 1 for pl in ctas.values())
    assert any(c * (4 if dt == torch.float32 else 2) % 16 for _, _, _, _, c, _, _, dt in K6_RAGGED)


def test_plan_refuses_rows_that_cannot_fit():
    """Where not even a one-column strip fits, the templated form is
    refused and the general form takes the call, cut by ``k6_gen_plan``:
    at d 200 on an 8^2 map only the centre tap reaches the image, so one
    tile of one tap, one row group."""
    plan = kdw.k6_plan(1, 8, 8, 128, 3, 200, 2, SMS)
    assert plan.general and plan.gen == kdw.k6_gen_plan(1, 8, 8, 128, 3, 200, 2, SMS)
    g = plan.gen
    assert (g.kri, g.krj, g.tj, g.ntj, g.ntg, g.kg, g.ngr, g.ngc) == (0, 0, 1, 1, 1, 1, 1, 1)
    assert g.strips == -(-8 // g.tw) and g.cblocks == 128 // kdw.K6_GEN_CH
    assert g.bands == -(-8 // g.rows) and g.slots(1) == g.bands * g.strips
    assert g.part_floats(1) == g.cblocks * g.slots(1) * 1 * kdw.K6_GEN_CH


def test_general_constants_match_the_kernel():
    """The general form's constants, its template instances and its shared
    memory as csrc/depthwise_wgrad.cu has them."""
    assert (K["GEN_CH"], K["GEN_CPT"], K["GEN_NPX"], K["GEN_TJ"], K["GEN_SEG"],
            K["GEN_ZERO"]) == (kdw.K6_GEN_CH, kdw.K6_GEN_CPT, kdw.K6_GEN_NPX, kdw.K6_GEN_TJ,
                               kdw.K6_GEN_SEG, kdw.K6_GEN_ZERO)
    assert K["GEN_TPC"] * K["GEN_CPT"] == K["GEN_CH"] and K["GEN_NPX"] * K["GEN_TPC"] == K["NT"]
    src = CU.read_text()
    cases = re.findall(r"case (\d+): return launch_gen_t<T, \1>", src)
    assert sorted(map(int, cases)) == list(range(1, K["GEN_TJ"] + 1))
    # gen_geom's terms, evaluated from the constants
    for h, w, k, d, tj, ntg, kg, tw, elem in ((64, 64, 9, 1, 5, 2, 2, 64, 2),
                                              (96, 300, 31, 9, 8, 3, 1, 38, 4),
                                              (12, 5000, 3, 4999, 1, 1, 1, 209, 2),
                                              (40, 37, 9, 6, 3, 1, 3, 9, 4)):
        krj = min((k - 1) // 2, (w - 1) // d)
        span = min(2 * krj + 1, ntg * tj)
        nxc = min(w, tw + (span - 1) * d)
        pb = K["GEN_CH"] * elem
        sk = K["ALIGN"] // pb  # a ring row's skew
        bwx, bwg = min(K["MAX_BOX"], nxc + sk - 1), min(K["MAX_BOX"], tw + sk - 1)
        up = lambda b: cdiv(b, K["ALIGN"]) * K["ALIGN"]  # noqa: E731
        xrow = up(cdiv(nxc + sk - 1, bwx) * bwx * pb)
        grow = up(cdiv(tw + sk - 1, bwg) * bwg * pb)
        ring = ((kg - 1) * d + K["G"] * (K["PRE"] + 1)) * xrow + K["G"] * (K["PRE"] + 1) * grow
        red = K["GEN_NPX"] * tj * K["GEN_CH"] * 4
        want = K["ALIGN"] + K["GEN_ZERO"] + max(ring, red)
        assert kdw.k6_gen_smem(h, w, k, d, tj, ntg, kg, tw, elem) == want


def test_routing_cut_keeps_the_models_templated():
    """The routing cut (``K6_GEN_HALO``, measured by ``tools/gen_forms.py
    --k6-route``) is pinned, and the segmenter's 14 launches, Xception's 9
    shapes and K6_RAGGED stay on the templated form; past the template's
    limits (k 9, a halo that leaves no strip) the general form runs."""
    from chip_smoke import XCEPTION_SHAPES

    assert kdw.K6_GEN_HALO == 25
    for _, h, c, d, _ in SEG_SHAPES:
        for elem in (2, 4):
            assert not kdw.k6_plan(8, h, h, c, 3, d, elem, SMS).general
    for name, h, c, d, _ in XCEPTION_SHAPES:
        assert not kdw.k6_plan(8, h, h, c, 3, d, 2, SMS).general, name
    for name, n, h, w, c, k, d, dt in K6_RAGGED:
        assert not kdw.k6_plan(n, h, w, c, k, d, 4 if dt == torch.float32 else 2, SMS).general
    assert kdw.k6_plan(8, 128, 128, 144, 9, 1, 2, SMS).general
    assert kdw.k6_plan(2, 96, 96, 128, 7, 48, 2, SMS).general
    for k, d in ((3, 24), (5, 12), (7, 8)):  # halo 24: the templated form
        assert not kdw.k6_plan(8, 128, 128, 144, k, d, 2, SMS).general
    for k, d in ((3, 25), (5, 13), (7, 9)):  # from halo 25: the general form
        assert kdw.k6_plan(8, 128, 128, 144, k, d, 2, SMS).general
    # the general form's own cut at a shape the templated form takes
    # (tools/gen_forms.py --k6-route launches it there through
    # _launch_k6_gen): the 3x3 taps, each row one tile of three columns
    g = kdw.k6_gen_plan(2, 64, 64, 128, 3, 1, 2, SMS)
    assert (g.kri, g.krj, g.tj, g.ntg) == (1, 1, 3, 1) and g.smem <= kdw.SMEM_LIMIT


def segments(nw, d, lpr):
    """The kernel's cut of a row: (class, first column index, length) of
    every segment."""
    m = cdiv(nw, d)
    seg = cdiv(m, max(1, lpr // d))
    spc = cdiv(m, seg)
    out = []
    for sg in range(d * spc):
        r, jc = sg // spc, (sg % spc) * seg
        out.append((r, jc, min(seg, cdiv(nw - r, d) - jc)))
    return out


@pytest.mark.parametrize("lpr", [2, 4, 8, 16])
def test_segments_cover_each_column_once(lpr):
    for nw in (1, 4, 11, 29, 34, 64, 128):
        for d in (1, 2, 3, 4, 20):
            cols = [r + (jc + j) * d for r, jc, ln in segments(nw, d, lpr) for j in range(max(ln, 0))]
            assert sorted(cols) == list(range(nw)), (nw, d, lpr)


# ----------------------------------------------------------- the emulation --

def emulate(x, dy, k, d, plan):
    """dW (k, k, 1, C) as K6 computes it under ``plan``, in f32, channels
    vectorised (the lanes of one pixel are independent)."""
    n, h, w, c = x.shape
    p = d * (k - 1) // 2
    cb_ch, g_rows, pre = plan.cb_ch, K["G"], K["PRE"]
    tpc = cb_ch // kdw.k6_cpt(k)
    npx = K["NT"] // tpc
    lpr, plw = npx // g_rows, 32 // tpc  # pixel lanes per row of a step, per warp
    nxs, ngs = 2 * p + g_rows * (pre + 1), g_rows * (pre + 1)
    xt = torch.zeros((n, h + 2 * p + plan.rows, w + 2 * p + plan.tw, plan.cblocks * cb_ch))
    xt[:, p: p + h, p: p + w, :c] = x  # x with TMA's zeros around it
    gt = torch.zeros((n, h + plan.rows, w + plan.tw, plan.cblocks * cb_ch))
    gt[:, :h, :w, :c] = dy
    slots = plan.slots(n)
    partial = torch.full((plan.cblocks, slots, k * k, cb_ch), float("nan"))
    for cb in range(plan.cblocks):
        cs = slice(cb * cb_ch, (cb + 1) * cb_ch)
        for slot in range(slots):
            strip, nb = slot % plan.strips, slot // plan.strips
            img, band = divmod(nb, plan.bands)
            h0, w0 = band * plan.rows, strip * plan.tw
            nrows, nw = min(plan.rows, h - h0), min(plan.tw, w - w0)
            steps = cdiv(nrows, g_rows)
            xring = torch.full((nxs, plan.tw + 2 * p, cb_ch), float("nan"))
            gring = torch.full((ngs, plan.tw, cb_ch), float("nan"))

            def issue(s):
                if s >= steps:
                    return
                j0, j1 = s * g_rows, min(s * g_rows + g_rows, nrows)
                lo, hi = (0 if s == 0 else j0 + 2 * p), j1 - 1 + 2 * p
                for rr in range(lo, hi + 1):  # image row h0 - p + rr, columns from w0 - p
                    xring[rr % nxs] = xt[img, h0 + rr, w0: w0 + plan.tw + 2 * p, cs]
                for j in range(j0, j1):
                    gring[j % ngs] = gt[img, h0 + j, w0: w0 + plan.tw, cs]

            acc = torch.zeros((npx, k * k, cb_ch))
            for s in range(pre):
                issue(s)
            for s in range(steps):
                issue(s + pre)  # before the sums, as the kernel may
                for gr in range(g_rows):
                    ro = s * g_rows + gr
                    if ro >= nrows:
                        continue
                    xr = [xring[(ro + ki * d) % nxs] for ki in range(k)]
                    grow = gring[ro % ngs]
                    for li in range(lpr):
                        pl = gr * lpr + li
                        for r, jc, ln in segments(nw, d, lpr)[li::lpr]:
                            if ln <= 0:
                                continue
                            col0 = r + jc * d
                            win = {(ki, kj): xr[ki][col0 + kj * d] for ki in range(k)
                                   for kj in range(k - 1)}
                            for j in range(ln):
                                jj, col = j % k, col0 + j * d
                                for ki in range(k):
                                    win[ki, (jj + k - 1) % k] = xr[ki][col + (k - 1) * d]
                                for ki in range(k):
                                    for kj in range(k):
                                        acc[pl, ki * k + kj] += win[ki, (jj + kj) % k] * grow[col]
            warps = []
            for wp in range(npx // plw):  # the butterfly over a warp's pixel lanes
                v = acc[wp * plw: (wp + 1) * plw].clone()
                off = 1
                while off < plw:
                    v = v + v[torch.arange(plw) ^ off]
                    off *= 2
                warps.append(v[0])
            mine = torch.zeros((k * k, cb_ch))
            for v in warps:
                mine = mine + v
            partial[cb, slot] = mine
    dw = torch.zeros((plan.cblocks * cb_ch, k * k))
    for cb in range(plan.cblocks):
        s = torch.zeros((k * k, cb_ch))
        for sl in range(slots):
            s = s + partial[cb, sl]
        dw[cb * cb_ch: (cb + 1) * cb_ch] = s.T
    return dw[:c].T.reshape(k, k, 1, c)


def _jax_dw(x, dy, k, d):
    c = x.shape[-1]
    p = d * (k - 1) // 2
    kern = jnp.zeros((k, k, 1, c), jnp.float32)
    _, vjp = jax.vjp(lambda b: jconv2d(jnp.asarray(x), b, stride=1, padding=p, dilation=d,
                                       groups=c), kern)
    return np.asarray(vjp(jnp.asarray(dy))[0])


EMULATED = [
    # (n, h, w, c, k, d, elem, forced (rows, tw) or None); forced plans
    # walk long bands, so that the rings wrap several times
    (2, 9, 11, 40, 3, 1, 2, None),
    (1, 13, 10, 48, 3, 2, 4, (13, 10)),  # f32: 16-channel blocks, 4 lanes a pixel
    (1, 14, 13, 36, 3, 4, 2, (14, 13)),  # d 4: most taps in the padding
    (2, 7, 13, 36, 3, 4, 2, None),
    (1, 10, 9, 32, 5, 1, 2, (10, 9)),
    (1, 6, 7, 24, 7, 1, 2, None),
    (1, 5, 6, 20, 1, 1, 4, None),
    (1, 11, 20, 32, 3, 2, 2, (11, 7)),   # column strips of 7
    (1, 6, 8, 70, 3, 1, 2, (3, 8)),      # C off the channel blocks: 32 + 32 + 6
]


@pytest.mark.parametrize("n,h,w,c,k,d,elem,forced", EMULATED,
                         ids=[f"{e[0]}x{e[1]}x{e[2]}x{e[3]}-k{e[4]}-d{e[5]}-e{e[6]}"
                              + ("-forced" if e[7] else "") for e in EMULATED])
def test_emulated_walk_matches_reference_and_jax(n, h, w, c, k, d, elem, forced):
    rng = np.random.default_rng(n * h * w + c + k + d)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    dy = rng.standard_normal((n, h, w, c)).astype(np.float32)
    plan = kdw.k6_plan(n, h, w, c, k, d, elem, SMS)
    if forced:
        rows, tw = forced
        plan = plan._replace(rows=rows, bands=cdiv(h, rows), tw=tw, strips=cdiv(w, tw))
    got = emulate(torch.from_numpy(x), torch.from_numpy(dy), k, d, plan)
    ref = kdw.depthwise_wgrad_reference(torch.from_numpy(x), torch.from_numpy(dy), k, d)
    scale = ref.abs().max().item()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-5 * scale
    assert np.abs(got.numpy() - _jax_dw(x, dy, k, d)).max() <= 1e-5 * scale
