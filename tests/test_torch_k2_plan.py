"""K2 (the RGB head) and its backward without a card: the plan, the
shared-memory budget and the kernels' arithmetic, emulated in torch.

``csrc/partial_conv.cu::pconv_k2`` is a GEMM with N padded to 8 over
operand rows that a CTA re-lays from its staged tile, and
``pconv_k2_bwd`` two more GEMMs over the same rows. A CUDA kernel cannot
run here, so these tests hold what surrounds the instructions:

  * ``k2_plan`` and the weight re-lays, at the head's shape and at ragged
    ones;
  * the shared memory of every plan within the 227 KB a CTA can take, with
    the layout read from the ``.cu`` itself (its ``constexpr int``s and the
    ``o += ...`` terms of ``k2_fwd_smem`` / ``k2_bwd_smem``), and the
    operand pitches that keep ``ldmatrix`` free of bank conflicts;
  * an emulation of the forward from the wrapper's own pieces (the re-laid
    weights, the padded K-major operand rows with the mask applied, a tap
    as a pixel offset into a tile's halo) against the plain version;
  * an emulation of the backward's tiling (the halo of dacc, the D rows,
    dx with the mask applied, per-CTA partial dW and db added in a fixed
    order) against ``jax.vjp`` of the JAX package's partial conv.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_segmentation_image_inpainting_tpu.ops import partial_conv as jpc
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


CU = Path(kpc.__file__).resolve().parents[2] / "csrc" / "partial_conv.cu"
TH, TW = kpc.K2_TH, kpc.K2_TW


def cu_constants() -> dict:
    """The ``constexpr int K2_*`` of csrc/partial_conv.cu, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (K2_\w+) = (.*?);", CU.read_text(), flags=re.M):
        env[name] = eval(expr.replace("/", "//"), {}, env)
    return env


def cu_smem_terms(fn: str) -> list:
    """The ``o += <expr>;`` terms of the layout function ``fn`` in the .cu."""
    body = re.search(rf"inline K2Smem {fn}\(.*?\n}}", CU.read_text(), flags=re.S).group(0)
    return re.findall(r"o \+= (.*?);", body)


K = cu_constants()


def test_python_mirrors_the_cu_constants():
    assert (K["K2_TH"], K["K2_TW"], K["K2_NPAD"]) == (kpc.K2_TH, kpc.K2_TW, kpc.K2_NPAD)
    assert (K["K2_CB_MAX"], K["K2_OPAD"]) == (kpc.K2_CB_MAX, kpc.K2_OPAD)
    assert K["K2_PIX"] == TH * TW and K["K2_TW"] == 16  # a tile row is one m16 row tile
    assert K["K2_THREADS"] == 32 * TH                   # one warp per tile row
    assert K["K2_CB_MAX"] % 16 == 0 and K["K2_JB"] == 32


@pytest.mark.parametrize("cin,cout,k,want", [
    (67, 3, 3, (80, 1, 32)),     # the head
    (12, 3, 3, (16, 1, 32)),
    (5, 7, 1, (16, 1, 16)),
    (80, 1, 3, (80, 1, 16)),
    (81, 2, 3, (48, 2, 32)),     # two blocks of one width
    (130, 3, 5, (80, 2, 80)),
    (512, 7, 7, (80, 7, 352)),
])
def test_k2_plan(cin, cout, k, want):
    plan = kpc.k2_plan(cin, cout, k)
    assert tuple(plan) == want
    assert plan.cb % 16 == 0 and 16 <= plan.cb <= kpc.K2_CB_MAX
    assert (plan.nblk - 1) * plan.cb < cin <= plan.nblk * plan.cb
    assert plan.kj % 16 == 0 and 0 <= plan.kj - k * k * cout < 16


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_shared_memory_fits_and_matches_the_cu(k):
    """Every plan's tile within a CTA's 227 KB, by the .cu's own layout."""
    def a16(b):
        return -(-b // 16) * 16

    for cin in (1, 5, 12, 67, 80, 81, 130, 512):
        for cout in range(1, 8):
            plan = kpc.k2_plan(cin, cout, k)
            env = dict(K, k=k, cb=plan.cb, kj=plan.kj, npx=(TH + k - 1) * (TW + k - 1),
                       k2_align16=a16, k2_raw_slot=lambda cb: a16(cb * 2 + 14))
            fwd = sum(eval(t, {}, env) for t in cu_smem_terms("k2_fwd_smem"))
            bwd = sum(eval(t, {}, env) for t in cu_smem_terms("k2_bwd_smem"))
            assert fwd == kpc.k2_smem_bytes(k, plan.cb) <= kpc.SMEM_LIMIT
            assert bwd == kpc.k2_smem_bytes(k, plan.cb, plan.kj) <= kpc.SMEM_LIMIT
            # the end of a backward pass keeps the warps' dW parts (4 pixel
            # groups x K2_JB rows x cb f32) and a tile's dx over the slots
            # and the operand rows
            slots = TH * TW * a16(plan.cb * 2 + 14)
            assert 4 * K["K2_JB"] * plan.cb * 4 <= slots + TH * TW * (plan.cb + kpc.K2_OPAD) * 2
            assert TH * TW * plan.cb * 2 <= slots
    assert kpc.SMEM_LIMIT == 227 * 1024


def test_operand_pitches_are_free_of_bank_conflicts():
    """A row pitch of an odd number of 16-byte chunks puts the eight rows of
    an ``ldmatrix`` into eight different chunks of the 128-byte bank line."""
    for n in range(16, 512 + 1, 16):  # every cb and every kj
        chunks = (n + kpc.K2_OPAD) * 2 // 16
        assert (n + kpc.K2_OPAD) * 2 % 16 == 0 and chunks % 2 == 1
        assert len({r * chunks % 8 for r in range(8)}) == 8


def _weight(rng, cout, cin, k):
    return torch.from_numpy((rng.standard_normal((cout, cin, k, k)) / np.sqrt(k * k * cin))
                            .astype(np.float32))


def test_weight_relayouts():
    rng = np.random.default_rng(0)
    w = _weight(rng, 3, 67, 3)
    plan = kpc.k2_plan(67, 3, 3)
    fwd = kpc.k2_weight_relayout(w, plan)
    assert fwd.shape == (1, 9, 8, 80) and fwd.dtype == torch.bfloat16
    want = w.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, 3, 67)
    assert torch.equal(fwd[0, :, :3, :67], want)
    assert (fwd[0, :, 3:] == 0).all() and (fwd[0, :, :, 67:] == 0).all()
    bwd = kpc.k2_bwd_weight_relayout(w, plan)
    assert bwd.shape == (80, 32)
    assert torch.equal(bwd[:67, :27].reshape(67, 9, 3), want.permute(2, 0, 1))
    assert (bwd[67:] == 0).all() and (bwd[:, 27:] == 0).all()
    # two blocks: block b holds channels [b cb, (b + 1) cb)
    w = _weight(rng, 2, 100, 1)
    plan = kpc.k2_plan(100, 2, 1)
    fwd = kpc.k2_weight_relayout(w, plan)
    assert fwd.shape == (2, 1, 8, 64)
    assert torch.equal(fwd[1, 0, :2, :36], w.to(torch.bfloat16)[:, 64:, 0, 0])
    assert (fwd[1, 0, :, 36:] == 0).all()


def _tiles(n, h, w):
    for img in range(n):
        for ty in range(-(-h // TH)):
            for tx in range(-(-w // TW)):
                yield img, ty * TH, tx * TW


def _operand_rows(x, mask, groups, img, r0, c0, rows, cols, cb0, cb):
    """What ``k2_relay`` writes for the (rows x cols) pixels from (r0, c0)
    of image ``img``: one row of ``cb`` channels per pixel, x * M_g rounded
    to x's type where the mask is not 0, exactly 0 where it is 0 (whatever x
    holds), outside the image and in the K padding."""
    _, h, w, cin = x.shape
    op = torch.zeros((rows * cols, cb), dtype=x.dtype)
    nb = min(cb, cin - cb0)
    grp = (torch.arange(cb0, cb0 + nb) >= groups[0]).long()
    for i in range(rows * cols):
        r, c = r0 + i // cols, c0 + i % cols
        if 0 <= r < h and 0 <= c < w:
            m = mask[img, r, c].float()[grp]
            v = (x[img, r, c, cb0:cb0 + nb].float() * m).to(x.dtype)
            op[i, :nb] = torch.where(m != 0, v, torch.zeros_like(v))
    return op


def _emulate_k2(x, mask, weight, bias, groups, pad):
    """K2's arithmetic from the wrapper's pieces: per 8 x 16 tile, the
    halo's operand rows; per tap, the 128 rows at the tap's pixel offset
    times the tap's re-laid (8, cb) weights, summed in f32 over taps and
    channel blocks; then the shared epilogue."""
    n, h, w, cin = x.shape
    cout, _, k, _ = weight.shape
    hout, wout = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    plan = kpc.k2_plan(cin, cout, k)
    wk = kpc.k2_weight_relayout(weight, plan).float()
    hw = TW + k - 1
    acc = torch.zeros((n, hout, wout, kpc.K2_NPAD))
    own = torch.tensor([r * hw + c for r in range(TH) for c in range(TW)])
    for img, r0, c0 in _tiles(n, hout, wout):
        tile = torch.zeros((TH * TW, kpc.K2_NPAD))
        for b in range(plan.nblk):
            op = _operand_rows(x, mask, groups, img, r0 - pad, c0 - pad, TH + k - 1, hw,
                               b * plan.cb, plan.cb).float()
            for tap in range(k * k):
                tile += op[own + (tap // k) * hw + tap % k] @ wk[b, tap].T
        rows, cols = min(TH, hout - r0), min(TW, wout - c0)
        acc[img, r0:r0 + rows, c0:c0 + cols] = tile.reshape(TH, TW, -1)[:rows, :cols]
    msum = mask_window_sum(mask, groups, (k, k), stride=(1, 1), padding=(pad, pad))
    b = None if bias is None else bias.to(x.dtype).float()
    return pconv_epilogue(acc[..., :cout], msum, b, float(k * k * cin), x.dtype)


def _bf16_case(seed, n, h, w, groups, cout, k):
    rng = np.random.default_rng(seed)
    cin = sum(groups)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(np.float32)).to(torch.bfloat16)
    m = torch.from_numpy((rng.random((n, h, w, len(groups))) < 0.6).astype(np.float32))
    m[0, :k + 1, :k + 1] = 0
    return x, m.to(torch.bfloat16), _weight(rng, cout, cin, k), \
        torch.from_numpy(rng.standard_normal(cout).astype(np.float32))


@pytest.mark.parametrize("n,h,w,groups,cout,k", [
    (2, 9, 19, (64, 3), 3, 3),      # the head's channels, ragged H and W
    (1, 17, 16, (67,), 3, 3),       # G 1
    (2, 10, 21, (7, 5), 2, 3),      # Cin 12
    (1, 8, 33, (5,), 7, 3),         # Cin 5
    (1, 11, 18, (100, 30), 1, 3),   # two channel blocks, a group boundary inside the first
    (1, 9, 17, (9, 3), 3, 5),       # k 5
    (1, 9, 17, (9, 3), 3, 1),       # 1x1
])
def test_emulated_forward_matches_the_plain_version(n, h, w, groups, cout, k):
    x, m, wt, b = _bf16_case(n * h + w, n, h, w, groups, cout, k)
    y, m_out = _emulate_k2(x, m, wt, b, groups, k // 2)
    y_ref, m_ref = kpc.partial_conv2d_reference(x, m, wt, b, group_sizes=groups,
                                                padding=(k // 2, k // 2))
    assert torch.equal(m_out, m_ref) and int((m_ref == 0).sum()) > 0
    # the same f32 sums in another order, each rounded once to bf16
    err = (y.float() - y_ref.float()).abs()
    assert (err <= 2.0**-7 * y_ref.float().abs() + 1e-3 * y_ref.float().abs().max()).all()
    assert (y[m_out[..., 0] == 0] == 0).all()


def test_emulated_forward_keeps_soft_masks_and_skips_holes():
    """x * M for a mask that is not binary; a NaN under a hole gives 0."""
    x, m, wt, b = _bf16_case(3, 1, 9, 18, (9, 3), 3, 3)
    soft = m * 0.5
    y, _ = _emulate_k2(x, soft, wt, b, (9, 3), 1)
    y_ref, _ = kpc.partial_conv2d_reference(x, soft, wt, b, group_sizes=(9, 3), padding=(1, 1))
    err = (y.float() - y_ref.float()).abs()
    assert (err <= 2.0**-7 * y_ref.float().abs() + 1e-3 * y_ref.float().abs().max()).all()
    clean, _ = _emulate_k2(x, m, wt, b, (9, 3), 1)
    x[0, 0, 0, 0] = float("nan")
    assert m[0, 0, 0, 0] == 0
    dirty, _ = _emulate_k2(x, m, wt, b, (9, 3), 1)
    assert torch.equal(clean, dirty)


def _emulate_k2_bwd(g, x, mask, weight, groups, pad, grid=3):
    """``pconv_k2_bwd``'s arithmetic: CTA ``b`` of ``grid`` takes tiles b,
    b + grid, ... of x's plane. Per tile: dacc over the halo of output
    pixels (the tile's own and k - 1 before), rounded to x's type; the D
    rows, D[q, tap * Cout + o] = dacc[q - tap + pad, o], zero in the padding
    of kj; dx = M * round(D @ W); the CTA's dW += D^T @ (x * M) and its db,
    in f32. The CTAs' parts are then added in CTA order."""
    n, h, w, cin = x.shape
    cout, _, k, _ = weight.shape
    hout, wout = g.shape[1:3]
    plan = kpc.k2_plan(cin, cout, k)
    cw = plan.nblk * plan.cb
    w2 = kpc.k2_bwd_weight_relayout(weight, plan).float() if x.dtype == torch.bfloat16 else None
    if w2 is None:  # the f32 cases keep the weights as they are
        w2 = torch.zeros((cw, plan.kj))
        w2[:cin, :k * k * cout] = weight.permute(1, 2, 3, 0).reshape(cin, -1)
    msum = mask_window_sum(mask, groups, (k, k), stride=(1, 1), padding=(pad, pad))
    scale = torch.where(msum > 0, torch.full_like(msum, k * k * cin) / msum.clamp(min=1.0), 0.0)
    hw = TW + k - 1
    joff = [((k - 1 - t // k) * hw + (k - 1 - t % k), o)
            for t in range(k * k) for o in range(cout)]
    dx = torch.zeros_like(x)
    parts_w = [torch.zeros((plan.kj, cw)) for _ in range(grid)]
    parts_b = [torch.zeros(cout) for _ in range(grid)]
    for t, (img, r0, c0) in enumerate(_tiles(n, max(h, hout), max(w, wout))):
        da = torch.zeros(((TH + k - 1) * hw, cout))
        for i in range(len(da)):
            oh, ow = r0 + pad - (k - 1) + i // hw, c0 + pad - (k - 1) + i % hw
            if 0 <= oh < hout and 0 <= ow < wout:
                da[i] = (g[img, oh, ow].float() * scale[img, oh, ow]).to(x.dtype).float()
                if r0 <= oh < r0 + TH and c0 <= ow < c0 + TW and msum[img, oh, ow] > 0:
                    parts_b[t % grid] += g[img, oh, ow].float()
        d = torch.zeros((TH * TW, plan.kj))
        for q in range(TH * TW):
            base = (q // TW) * hw + q % TW
            for j, (off, o) in enumerate(joff):
                d[q, j] = da[base + off, o]
        for b in range(plan.nblk):
            cb0, nb = b * plan.cb, min(plan.cb, cin - b * plan.cb)
            xm = _operand_rows(x, mask, groups, img, r0, c0, TH, TW, cb0, plan.cb).float()
            one = torch.ones((1, h, w, cin), dtype=x.dtype)
            mk = _operand_rows(one, mask[img:img + 1], groups, 0, r0, c0, TH, TW, cb0, plan.cb)
            tile_dx = ((d @ w2[cb0:cb0 + plan.cb].T).to(x.dtype) * mk).reshape(TH, TW, -1)
            rows, cols = max(0, min(TH, h - r0)), max(0, min(TW, w - c0))
            dx[img, r0:r0 + rows, c0:c0 + cols, cb0:cb0 + nb] = tile_dx[:rows, :cols, :nb]
            parts_w[t % grid][:, cb0:cb0 + plan.cb] += d.T @ xm
    dw, db = parts_w[0], parts_b[0]
    for pw, pb in zip(parts_w[1:], parts_b[1:]):
        dw, db = dw + pw, db + pb
    dw = dw[:k * k * cout, :cin].reshape(k, k, cout, cin).permute(2, 3, 0, 1)
    return dx, dw, db


def _f32_case(seed, groups, cout, hw, k=3):
    rng = np.random.default_rng(seed)
    cin = sum(groups)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    m = (rng.random((2, *hw, len(groups))) < 0.6).astype(np.float32)
    m[0, :4, :4] = 0
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal((cout,))).astype(np.float32)
    g = rng.standard_normal((2, *hw, cout)).astype(np.float32)
    return x, m, w, b, g


def _jax_grads(x, m, w, b, g, groups, pad):
    def f(x, w, b):
        y, _ = jpc._partial_conv2d_xla(x, jnp.asarray(m), w, b, groups, (1, 1), (pad, pad), (1, 1))
        return y

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("groups,cout,hw,k", [
    ((64, 3), 3, (9, 19), 3),     # the head's channels, ragged
    ((12,), 3, (17, 16), 3),      # G 1
    ((3, 2), 7, (8, 33), 3),      # Cin 5, kj 63 -> 64: two passes of dW rows
    ((50, 40), 2, (9, 17), 3),    # two channel blocks
    ((7, 5), 3, (9, 17), 1),      # 1x1
])
def test_emulated_backward_matches_jax_vjp(groups, cout, hw, k):
    """f32 throughout (the roundings to x's type are no-ops), so only the
    order of the sums differs: rtol 1e-4 / atol 1e-5, as K3's plain version
    is held in test_torch_train_ops.py."""
    x, m, w, b, g = _f32_case(sum(groups) + cout, groups, cout, hw, k)
    want = _jax_grads(x, m, w, b, g, groups, k // 2)
    t = torch.from_numpy
    wt = t(w.transpose(3, 2, 0, 1).copy())
    dx, dw, db = _emulate_k2_bwd(t(g), t(x), t(m), wt, groups, k // 2)
    got = dx.numpy(), dw.numpy().transpose(2, 3, 1, 0), db.numpy()
    for name, a, r in zip(("dx", "dW", "db"), got, want):
        np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-5, err_msg=name)
    plain = kpc.partial_conv2d_backward_reference(t(g), t(x), t(m), wt, t(b), groups,
                                                  (k // 2, k // 2))
    for name, a, r in zip(("dx", "dW", "db"), plain, want):
        r = r.transpose(3, 2, 0, 1) if name == "dW" else r
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=1e-5, err_msg=f"plain {name}")


def test_emulated_backward_all_hole_page_is_exactly_zero():
    x, m, w, b, g = _f32_case(5, (9, 3), 3, (9, 17))
    m[:] = 0
    x[0, 0, 0, 0] = np.inf
    t = torch.from_numpy
    for a in _emulate_k2_bwd(t(g), t(x), t(m), t(w.transpose(3, 2, 0, 1).copy()), (9, 3), 1):
        assert (a == 0).all()


def test_emulated_backward_rounds_as_the_plain_version():
    """In bf16 the emulation rounds dacc and dx where K3's plain version
    does: dx within one bf16 step, dW and db within the order of f32 sums."""
    x, m, wt, b = _bf16_case(9, 2, 9, 19, (64, 3), 3, 3)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 9, 19, 3))
                         .astype(np.float32)).to(torch.bfloat16)
    wb = wt.to(torch.bfloat16)
    dx, dw, db = _emulate_k2_bwd(g, x, m, wb, (64, 3), 1)
    rdx, rdw, rdb = kpc.partial_conv2d_backward_reference(g, x, m, wb, b.to(torch.bfloat16),
                                                          (64, 3), (1, 1))
    top = rdx.float().abs().max().item()
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=2**-7, atol=2e-3 * top)
    torch.testing.assert_close(dw.to(torch.bfloat16).float(), rdw.float(), rtol=2**-7,
                               atol=2e-3 * rdw.float().abs().max().item())
    torch.testing.assert_close(db.to(torch.bfloat16).float(), rdb.float(), rtol=2**-7, atol=1e-2)
