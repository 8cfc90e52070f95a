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
  Cout >= 8) and 1..4 mask groups, and K6's over odd k up to 15 and
  dilations up to 64: the templated form within its shared memory, as the
  ``.cu`` files' constants give it, else the general form (which takes no
  shared memory).
* The general forms (``csrc/partial_conv.cu``: ``pconv_gen_fwd``,
  ``pconv_gen_dx``, ``pconv_gen_dw``; ``csrc/depthwise_wgrad.cu``:
  ``dw_wgrad_gen``) emulated in torch, their index arithmetic and order of
  sums (lane-strided channels and the xor butterfly; the chunks of output
  pixels and ``pconv_colsum``'s order), against ``jax.vjp``, at even k,
  unequal padding, padding above k - 1 and three groups.
* The port's ``partial_conv2d`` and its gradients against JAX's
  ``impl='pallas'`` (interpret mode) in f32 at Cin 200 (k 3), Cin 67 at k 2
  and 9, and three mask groups; K6's plain version at k 9 against
  ``jax.vjp`` of JAX's depthwise conv.
"""

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


def test_general_forms_take_no_shared_memory():
    """The general forms' kernels declare no shared memory and launch
    GEN_THREADS threads (K6's its own NT), the forward GEN_PIX output pixels
    a warp: whatever Cin, k and G are, their plans need no budget."""
    src = (CSRC / "partial_conv.cu").read_text()
    assert _cu_constexpr("partial_conv.cu", "GEN_THREADS") == str(kpc.GEN_THREADS)
    assert _cu_constexpr("partial_conv.cu", "GEN_PIX") == str(kpc.GEN_PIX)
    for kernel in ("pconv_gen_fwd", "pconv_gen_dx", "pconv_gen_dw"):
        body = src.split(f"__launch_bounds__(GEN_THREADS) {kernel}(")[1].split("\n}\n")[0]
        assert "__shared__" not in body, kernel
    assert "pconv_gen_fwd<T, CO><<<grid, GEN_THREADS, 0, s>>>" in src
    dws = (CSRC / "depthwise_wgrad.cu").read_text()
    for kernel in ("dw_wgrad_gen(", "dw_wgrad_gen_sum("):
        body = dws.split(f"__launch_bounds__(NT) {kernel}")[1].split("\n}\n")[0]
        assert "__shared__" not in body, kernel


@pytest.mark.parametrize("k", KS)
def test_small_cout_plans_return_over_the_scope(k):
    """K2 and K2F (Cout 1..7) and their backwards: a plan at every Cin, Cout,
    group count and padding (JAX's scope has no limit on any of them); the
    templated form only where its shared memory fits (``k2_smem_bytes``,
    ``k2f_smem_bytes``, ``k2f_bwd_smem_bytes``, held to the ``.cu``'s
    layout by test_torch_k2_plan.py and test_torch_f32_kernels.py), one or
    two groups and, for K2's backward, a padding up to k - 1."""
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
                    assert k in kpc.K2F_KS and g <= 2 and bwd.nseg * cin <= kpc.HB_THREADS
                    assert kpc.k2f_bwd_smem_bytes(cin, cout, k, bwd.nseg) <= kpc.SMEM_LIMIT
                for pad in ((0, 0), (k - 1, k - 1), (k, 1), (k + 3, 0)):
                    for backward in (False, True):
                        if kpc.k2_general(cin, cout, k, g, pad, backward):
                            continue
                        assert g <= 2 and (not backward or max(pad) <= k - 1)
                        kj = k2.kj if backward else 0
                        assert kpc.k2_smem_bytes(k, k2.cb, kj) <= kpc.SMEM_LIMIT


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


@pytest.mark.parametrize("k", range(1, 16, 2))
def test_k6_plans_return_over_the_scope(k):
    """K6 at every odd k up to 15 and dilation up to 64, and 5000 (JAX's
    depthwise ``supported``: any odd k, equal dilations): the templated
    form at k in K6_KERNEL_SIZES and a dilation its launcher takes, while a
    strip with its halo fits one TMA row and the shared memory, else the
    general form, whose partials stay within GEN_PART_FLOATS."""
    src = (CSRC / "depthwise_wgrad.cu").read_text()
    assert f"if (d > {kdw.K6_MAX_DILATION} ||" in src  # the templated launcher's limit
    for d in (1, 2, 4, 8, 16, 32, 48, 64, 5000):
        for c in (128, 200, 1024):
            for elem in (2, 4):
                for n, h, w in ((2, 64, 64), (1, 96, 300)):
                    plan = kdw.k6_plan(n, h, w, c, k, d, elem, SMS)
                    if plan.general:
                        assert 1 <= plan.chunks <= n * h * w
                        assert plan.chunks * k * k * c <= max(kpc.GEN_PART_FLOATS, k * k * c)
                        continue
                    p = d * (k - 1) // 2
                    assert k in kdw.K6_KERNEL_SIZES and d <= kdw.K6_MAX_DILATION
                    assert plan.tw + 2 * p <= kdw.K6_MAX_BOX and plan.smem <= kdw.SMEM_LIMIT
                    assert plan.smem == kdw.k6_smem_bytes(k, p, plan.tw, elem)


# -- the general forms, emulated --------------------------------------------------------

def emulate_gen_fwd(x, m, w, b, groups, pad):
    """``pconv_gen_fwd`` in torch f32: lane l (of 32) sums, tap by tap,
    channels l, l + 32, ... of x * M times W for each output pixel; the xor
    butterfly (16, 8, 4, 2, 1) adds the lanes; the window count and the
    epilogue as K2's. (A warp's GEN_PIX pixels share only the loads.)"""
    n, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    ph, pw = pad
    hout, wout = h + 2 * ph - k + 1, wd + 2 * pw - k + 1
    cp = -(-cin // 32) * 32
    xm = F.pad(apply_mask(x, m, groups), (0, cp - cin, pw, pw, ph, ph))
    wt = F.pad(w.permute(2, 3, 1, 0), (0, 0, 0, cp - cin))  # (k, k, Cp, Cout)
    acc = torch.zeros((n, hout, wout, 32, cout))
    for tap in range(k * k):
        dy, dx = divmod(tap, k)
        patch = xm[:, dy:dy + hout, dx:dx + wout].reshape(n, hout, wout, cp // 32, 32)
        wj = wt[dy, dx].reshape(cp // 32, 32, cout)
        for j in range(cp // 32):
            acc = acc + patch[..., j, :, None] * wj[j]
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., torch.arange(32) ^ off, :]
    msum = mask_window_sum(m, groups, (k, k), stride=(1, 1), padding=pad)
    return pconv_epilogue(acc[..., 0, :], msum, b, float(k * k * cin), x.dtype)


def emulate_gen_bwd(g, x, m, w, groups, pad):
    """``pconv_gen_dx`` and ``pconv_gen_dw`` after ``pconv_k3_prep``, in torch
    f32: dacc = g * scale where the window has a valid tap; dx[ih, iw, c] =
    (sum over taps dy-major and outputs of dacc[ih + ph - dy, iw + pw - dx]
    * W) times the channel's group mask, at any padding; dW per chunk of
    output pixels (``gen_chunks``) and the chunks added as ``pconv_colsum``
    adds them (rows y, y + 8, ... then the 8 sums in order)."""
    n, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    ph, pw = pad
    hout, wout = g.shape[1:3]
    msum = mask_window_sum(m, groups, (k, k), stride=(1, 1), padding=pad)
    dacc = torch.where(msum > 0, g * (float(k * k * cin) / msum.clamp(min=1.0)), 0.0)
    dpad = F.pad(dacc, (0, 0, k - 1, k - 1, k - 1, k - 1))
    dxm = torch.zeros_like(x)
    for ky in range(k):
        for kx in range(k):
            r0, c0 = ph - ky + k - 1, pw - kx + k - 1
            win = dpad[:, r0:r0 + h, c0:c0 + wd]  # (n, h, w, cout) at oh = ih + ph - ky
            for o in range(cout):
                dxm = dxm + win[..., o:o + 1] * w[o, :, ky, kx]
    dx = apply_mask(dxm, m, groups)
    xm = F.pad(apply_mask(x, m, groups), (0, 0, pw, pw, ph, ph))
    pix = n * hout * wout
    chunks = kpc.gen_chunks(pix, k * k * cout * cin)
    rows = []
    for z in range(chunks):
        lo, hi = z * pix // chunks, (z + 1) * pix // chunks
        part = torch.zeros((k, k, cout, cin))
        for ky in range(k):
            for kx in range(k):
                xs = xm[:, ky:ky + hout, kx:kx + wout].reshape(pix, cin)[lo:hi]
                part[ky, kx] = dacc.reshape(pix, cout)[lo:hi].T @ xs
        rows.append(part)
    sums = [sum(rows[y::8], torch.zeros_like(rows[0])) for y in range(min(8, chunks))]
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return dx, total.permute(2, 3, 0, 1)


GEN_CASES = [  # groups, cout, k, padding
    ((5, 6), 3, 2, (1, 0)),             # even k, unequal padding
    ((3, 3, 2), 3, 3, (1, 1)),           # three groups
    ((24, 16, 8), 2, 3, (4, 1)),         # three groups, padding above k - 1
    ((40,), 1, 5, (2, 2)),               # one group, Cout 1
    ((150, 50), 5, 4, (1, 2)),           # Cin 200: lanes take 6 or 7 channels each
    ((9, 4), 7, 4, (3, 2)),              # even k 4, padding k - 1 and above
]


@pytest.mark.parametrize("groups,cout,k,pad", GEN_CASES,
                         ids=["-".join(map(str, (*c[0], c[1], c[2], *c[3]))) for c in GEN_CASES])
def test_general_forms_emulated_match_jax_vjp(groups, cout, k, pad):
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
    y, nm = emulate_gen_fwd(tx, tm, tw, torch.from_numpy(b), groups, pad)
    np.testing.assert_array_equal(nm.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    dx, dw = emulate_gen_bwd(torch.from_numpy(g), tx, tm, tw, groups, pad)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw).transpose(3, 2, 0, 1),
                               rtol=RTOL, atol=ATOL)


def emulate_k6_gen(x, dy, k, d):
    """``dw_wgrad_gen`` and ``dw_wgrad_gen_sum`` in torch f32: each chunk of
    output pixels (``gen_chunks``) sums x * dy per (tap, channel); the
    chunks are added in order."""
    n, h, w, c = x.shape
    p = d * (k - 1) // 2
    pix = n * h * w
    xp = F.pad(x, (0, 0, p, p, p, p))
    chunks = kpc.gen_chunks(pix, k * k * c)
    total = torch.zeros((k, k, c))
    for z in range(chunks):
        lo, hi = z * pix // chunks, (z + 1) * pix // chunks
        part = torch.zeros((k, k, c))
        for ki in range(k):
            for kj in range(k):
                xs = xp[:, ki * d:ki * d + h, kj * d:kj * d + w].reshape(pix, c)[lo:hi]
                part[ki, kj] = (xs * dy.reshape(pix, c)[lo:hi]).sum(0)
        total = total + part
    return total.unsqueeze(2)


def _jax_depthwise_wgrad(x, dy, k, d):
    c = x.shape[-1]
    p = d * (k - 1) // 2
    kern = jnp.zeros((k, k, 1, c), jnp.float32)
    _, vjp = jax.vjp(lambda kk: jconv2d(jnp.asarray(x), kk, stride=1, padding=p, dilation=d,
                                        groups=c), kern)
    return np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("k,d", [(9, 1), (7, 3), (3, 9), (11, 2)])
def test_k6_general_form_and_plain_match_jax_vjp(k, d):
    """K6's general form (emulated) and its plain version, at windows the
    templated form is not built for and a dilation whose halo is wider than
    the page, against ``jax.vjp`` of JAX's depthwise conv."""
    rng = np.random.default_rng(k * 10 + d)
    x = rng.standard_normal((2, 12, 13, 8)).astype(np.float32)
    dy = rng.standard_normal((2, 12, 13, 8)).astype(np.float32)
    want = _jax_depthwise_wgrad(x, dy, k, d)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    np.testing.assert_allclose(emulate_k6_gen(tx, tdy, k, d).numpy(), want, rtol=1e-4, atol=1e-4)
    plain = kdw.depthwise_wgrad(tx, tdy, k, d)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-4, atol=1e-4)


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
