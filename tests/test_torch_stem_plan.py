"""K4's and K5's geometry on the CPU: the persistent tile walk, the shared
memory budget, and the flat-pixel-list arithmetic of csrc/vgg_stem.cu.

The kernels run only on the card; what they compute is fixed by a few
constants and offsets. These tests take the constants from the CUDA
source itself (every namespace-scope ``constexpr int``, evaluated in
order) and hold:

  * the walk of the persistent CTAs (``stem_grid``, ``stem_schedule``):
    every 16x16 tile exactly once, for grids below, at and above the SM
    count and for ragged pages;
  * each kernel's shared memory within the 227 KB a block can use;
  * an emulation, in f32 torch, of what each tile does with those
    constants: the flat pixel lists of pitch P, conv1's taps at
    ``ky*P + kx`` over each consumer warpgroup's rows, its dgrad at
    ``(2-ky)*P + (2-kx)``, the first-max routing of the pool gradient,
    the 2x2 pool over the tile's rows, K4's last dgrad as a product and a
    tap gather. Rows and columns that only the ignored outputs read are
    filled with NaN, so any valid output that reached them would fail.
    Both emulations must equal ``stem_pool_reference`` and
    ``stem_dx_reference`` in f32 within 1e-5 of the largest value.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
from tests.test_torch_bridge import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


CU = Path(kvs.__file__).resolve().parents[2] / "csrc" / "vgg_stem.cu"
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on Hopper


def cu_constants() -> dict:
    """Every namespace-scope ``constexpr int`` of csrc/vgg_stem.cu, evaluated
    in order with C's integer division."""
    env = {"cdiv": lambda a, b: -(-a // b), "cmax": max, "up8": lambda a: -(-a // 8) * 8}
    for stmt in re.findall(r"^constexpr int (.*?);", CU.read_text(), flags=re.M | re.S):
        depth, part, parts = 0, "", []
        for ch in stmt:
            depth += (ch == "(") - (ch == ")")
            if ch == "," and depth == 0:
                parts.append(part)
                part = ""
            else:
                part += ch
        for decl in parts + [part]:
            name, expr = decl.split("=", 1)
            expr = re.sub(r"(?<![/])/(?![/])", "//", " ".join(expr.split()))
            env[name.strip()] = eval(expr, {}, env)
    return env


K = cu_constants()


# --------------------------------------------------------------- the walk --

SHAPES = [(1, 16, 16), (1, 18, 26), (2, 32, 48), (3, 16, 16), (1, 176, 208), (2, 512, 512),
          (16, 512, 512)]


@pytest.mark.parametrize("sms", [1, 7, 132, 10_000])
@pytest.mark.parametrize("m,h,w", SHAPES, ids=[f"{m}x{h}x{w}" for m, h, w in SHAPES])
def test_schedule_covers_every_tile_once(m, h, w, sms):
    tiles = kvs.stem_tiles(m, h, w)
    grid = kvs.stem_grid(m, h, w, sms)
    plan = kvs.stem_schedule(m, h, w, sms)
    assert grid == min(sms, tiles) and len(plan) == grid
    assert all(plan)  # no CTA without a tile
    every = [t for cta in plan for t in cta]
    want = [(n, y, x) for n in range(m) for y in range(0, h, 16) for x in range(0, w, 16)]
    assert sorted(every) == sorted(want) and len(every) == len(set(every)) == tiles
    # CTA b takes tiles b, b + grid, ...: the counts differ by at most one
    counts = [len(cta) for cta in plan]
    assert max(counts) - min(counts) <= 1 and counts == sorted(counts, reverse=True)
    assert plan[0][0] == (0, 0, 0)


def test_schedule_at_the_train_shapes():
    """K4 at 16 pages and K5 at 8 (512^2) on 132 SMs: 16384 and 8192 tiles,
    so every CTA takes 124 or 125 (62 or 63) tiles; the last wave is partial."""
    for m, per in ((16, (125, 124)), (8, (63, 62))):
        counts = {len(c) for c in kvs.stem_schedule(m, 512, 512, 132)}
        assert counts == set(per)


def test_the_tile_matches_the_kernels():
    assert kvs.STEM_TILE == K["DX_TH"] == K["DX_TW"] == K["PL_TH"] == K["PL_TW"]


# ------------------------------------------------------------ the budget --

@pytest.mark.parametrize("kernel", ["DX_SMEM", "PL_SMEM"])
def test_shared_memory_within_the_block_limit(kernel):
    assert K[kernel] <= SMEM_LIMIT
    assert K["THREADS"] == K["CONSUMERS"] + K["PRODUCERS"] == 384


def test_shared_memory_parts():
    """K4: conv1's weights, conv0's and their transpose, a0/gz0, z1/gz1, x,
    g, conv1's bias, 1 KB of alignment; K5: weights, three input buffers,
    bias, 1 KB. K4's z1 buffer also holds the im2col of x and Q in turn."""
    assert K["W1_BYTES"] == 9 * 64 * 128
    assert K["DX_SMEM"] == (1024 + K["W1_BYTES"] + 64 * 64 + 64 * 128 + K["DX_A0_ROWS"] * 128
                            + K["DX_Z1_ROWS"] * 128 + 24 * 24 * 3 * 2 + 10 * 10 * 128 + 64 * 4)
    assert max(K["XCOL_BYTES"], K["Q_BYTES"]) <= K["DX_Z1_BYTES"]
    assert 2 * K["DX_C0_N"] == K["DX_A0_ROWS"] >= (K["DX_TH"] + 6) * K["DX_P"]
    assert K["PL_SMEM"] == 1024 + K["W1_BYTES"] + K["PL_STAGES"] * K["PL_A0_ROWS"] * 128 + 64 * 4
    for name in ("W1_BYTES", "W0T_BYTES", "W0C_BYTES", "DX_A0_BYTES", "PL_A0_BYTES"):
        assert K[name] % 1024 == 0  # swizzled tiles start on the swizzle's period


# -------------------------------------------------------- the emulations --

def _rng_weights(seed):
    """bf16-representable f32 weights and biases: the kernels round both."""
    rng = np.random.default_rng(seed)
    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            torch.bfloat16).float()
    return t((64, 3, 3, 3), 0.3), t((64,), 0.1), t((64, 64, 3, 3), 0.06), t((64,), 0.1)


def _conv1_rows(src, w1, pitch, rows, dgrad):
    """conv1 over flat pixel rows ``rows`` of ``src``, one consumer
    warpgroup's: forward taps at ky*P + kx with W1[t] as (out, in), the
    dgrad at (2-ky)*P + (2-kx) with its transpose."""
    out = torch.zeros((len(rows), 64))
    for t in range(9):
        ky, kx = divmod(t, 3)
        off = (2 - ky) * pitch + (2 - kx) if dgrad else ky * pitch + kx
        wt = w1[:, :, ky, kx]  # (out, in)
        a = src[rows.start + off: rows.stop + off]
        assert a.shape[0] == len(rows), "a tap reads past the buffer"
        out += a @ (wt if dgrad else wt.T)
    return out


def emulate_k5(z0, w1, b1):
    """K5's tiles from the kernel's constants: the input buffer of PL_A0_ROWS
    pixel rows (the halo of relu(z0), then NaN), each warpgroup's PL_N rows
    of z1, and its 4 rows of pool windows."""
    m, h, w, _ = z0.shape
    P, N, T = K["PL_P"], K["PL_N"], K["PL_TH"]
    out = torch.full((m, h // 2, w // 2, 64), float("nan"))
    for cta in kvs.stem_schedule(m, h, w, 3):
        for n, y0, x0 in cta:
            buf = torch.full((K["PL_A0_ROWS"], 64), float("nan"))
            for r in range(K["PL_IN_ROWS"]):
                ih, iw = y0 - 1 + r // P, x0 - 1 + r % P
                inside = 0 <= ih < h and 0 <= iw < w
                buf[r] = z0[n, ih, iw].clamp_min(0) if inside else 0
            for wg in range(2):
                z1 = _conv1_rows(buf, w1, P, range(wg * N, wg * N + N), False) + b1
                z1 = z1.reshape(T // 2, P, 64)[:, :T].clamp_min(0)  # columns past T ignored
                pooled = z1.reshape(T // 4, 2, T // 2, 2, 64).amax(dim=(1, 3))
                for wr in range(T // 4):
                    py = y0 // 2 + wg * T // 4 + wr
                    for wc in range(T // 2):
                        px = x0 // 2 + wc
                        if py < h // 2 and px < w // 2:
                            out[n, py, px] = pooled[wr, wc]
    return out


def emulate_k4(x, g, w0, b0, w1, b1):
    """K4's tiles from the kernel's constants: the im2col of x (with a
    column of ones for the bias, all zero outside the image) and conv0 over
    DX_A0_ROWS rows; z1 over 2 x DX_Z1_N rows; the pool gradient in
    place (the other rows keep z1, here NaN); gz0 over 2 x DX_GZ0_N rows
    where a0 > 0, over a0 2 rows and 2 columns in; Q = gz0 W0; dx by the
    tap gather of Q."""
    m, h, w, _ = x.shape
    P, T = K["DX_P"], K["DX_TH"]
    h2, w2 = h // 2, w // 2
    w0c = w0.permute(0, 2, 3, 1).reshape(64, 27)  # (out, k = (ky*3 + kx)*3 + in)
    w0b = torch.cat([w0c, b0[:, None]], dim=1)    # k = 27: the bias
    dx = torch.full((m, h, w, 3), float("nan"))
    for cta in kvs.stem_schedule(m, h, w, 5):
        for n, y0, x0 in cta:
            xs = torch.zeros((T + 8, T + 8, 3))
            for r in range(T + 8):
                for c in range(T + 8):
                    ih, iw = y0 - 4 + r, x0 - 4 + c
                    if 0 <= ih < h and 0 <= iw < w:
                        xs[r, c] = x[n, ih, iw]
            a0 = torch.zeros((K["DX_A0_ROWS"], 64))
            for pix in range(K["DX_A0_ROWS"]):
                r, c = divmod(pix, P)
                ih, iw = y0 - 3 + r, x0 - 3 + c
                if r < T + 6 and 0 <= ih < h and 0 <= iw < w:
                    col = torch.cat([xs[r:r + 3, c:c + 3].reshape(27), torch.ones(1)])
                    a0[pix] = (col @ w0b.T).clamp_min(0)
            z1 = torch.full((K["DX_Z1_ROWS"], 64), float("nan"))
            for wg in range(2):
                rows = range(wg * K["DX_Z1_N"], (wg + 1) * K["DX_Z1_N"])
                z1[rows.start:rows.stop] = _conv1_rows(a0, w1, P, rows, False) + b1
            gz1 = torch.full_like(z1, float("nan"))  # rows outside the windows keep z1
            for wr in range(T // 2 + 2):
                for wc in range(T // 2 + 2):
                    py, px = y0 // 2 - 1 + wr, x0 // 2 - 1 + wc
                    gv = g[n, py, px] if 0 <= py < h2 and 0 <= px < w2 else torch.zeros(64)
                    q = [2 * wr * P + 2 * wc + d for d in (0, 1, P, P + 1)]
                    v = z1[q].clamp_min(0)  # (4, 64)
                    mx = v.max(dim=0).values
                    first = (v == mx).float().argmax(dim=0)  # first maximum, row-major
                    for k in range(4):
                        gz1[q[k]] = torch.where((first == k) & (mx > 0), gv, torch.zeros(64))
            gz0 = torch.zeros((2 * K["DX_GZ0_N"], 64))
            for wg in range(2):
                rows = range(wg * K["DX_GZ0_N"], (wg + 1) * K["DX_GZ0_N"])
                gz0[rows.start:rows.stop] = _conv1_rows(gz1, w1, P, rows, True)
            keep = a0[2 * P + 2: 2 * P + 2 + 2 * K["DX_GZ0_N"]] > 0
            gz0 = torch.where(keep, gz0, torch.zeros(()))
            q = gz0 @ w0c  # (rows, 27): Q[g][3 t + ch]
            for i in range(T):
                for j in range(T):
                    ih, iw = y0 + i, x0 + j
                    if ih >= h or iw >= w:
                        continue
                    d = i * P + j
                    dx[n, ih, iw] = sum(q[d + (2 - t // 3) * P + (2 - t % 3), 3 * t: 3 * t + 3]
                                        for t in range(9))
    return dx


def _close(got, want):
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("m,h,w", [(1, 16, 16), (2, 18, 26), (1, 32, 48)])
def test_emulated_k5_equals_the_plain_version(m, h, w):
    _, _, w1, b1 = _rng_weights(h + w)
    rng = np.random.default_rng(m * h * w)
    z0 = torch.from_numpy(rng.standard_normal((m, h, w, 64)).astype(np.float32))
    _close(emulate_k5(z0, w1, b1), kvs.stem_pool_reference(z0, w1, b1))


@pytest.mark.parametrize("m,h,w", [(1, 16, 16), (2, 18, 26), (1, 32, 20)])
def test_emulated_k4_equals_the_plain_version(m, h, w):
    w0, b0, w1, b1 = _rng_weights(h * w)
    rng = np.random.default_rng(m + h + w)
    x = torch.from_numpy(rng.standard_normal((m, h, w, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((m, h // 2, w // 2, 64)).astype(np.float32))
    _close(emulate_k4(x, g, w0, b0, w1, b1), kvs.stem_dx_reference(x, g, w0, b0, w1, b1))
