"""BatchNorm's glue: the plan, the plain route and, on a card, the kernels.

``ops/kernels/batchnorm.py``. Without a card: ``bn_plan`` at every
BatchNorm shape of the benchmark's four cells (the segmenters and the
U-Net traced at a smaller size by hooks and scaled to 512^2, batch 8) and
at ragged rows, held to its invariants and to ``csrc/batchnorm.cu``'s
constants; the plain route with each fused activation equal to BatchNorm
followed by the model's activation, counted as ``bn.plain``; every
BatchNorm call of the cells' models counted once and handed the
activation that follows it; and a torch
emulation of the kernels' arithmetic (z rounded step by step, the
activation on z cast to x's dtype and its backward by that value,
dx = scale (g - Sum g / M - xhat Sum g xhat / M), the clamped variance's
term dropped) against autograd of the plain chain, in bf16 and f32, with
the batch's statistics and the running ones.

Marked ``gpu`` (skipped without a CUDA device, decided in the fixture):
the kernels against the plain chain on the card in bf16 and f32, in
train, frozen and eval mode, with each activation: y, the running
statistics and num_batches_tracked, dx, dweight, dbias; a constant
channel (the variance clamped); C in {16, 24, 144, 728, 2048}; rows that
are no multiple of a CTA's; a non-contiguous input; two launches
bit-identical; ``BN_LAUNCHES`` and ``bn.kernel``; and two ranks under
``data_parallel`` on ``cuda:0`` (gloo, ``tests/torch_ddp_worker.py``)
against the plain chain on the whole batch. On the card:

    python -m pytest -m gpu --noconftest tests/test_torch_batchnorm.py
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, TextSegmenter
from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import _ACTS, BatchNorm
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import batchnorm as kbn
from text_segmentation_image_inpainting_tpu_torch.utils.profiling import counters

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "text_segmentation_image_inpainting_tpu_torch" / "csrc" / "batchnorm.cu"
WORKER = REPO / "tests" / "torch_ddp_worker.py"
SMS = 132  # the H100's SMs
ACTS = tuple(kbn.FUSED_ACTS)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bn_shapes(model, x, *args, scale: int) -> set:
    """(rows, C) of every BatchNorm ``model`` runs on ``x``, at batch 8 and
    the spatial size ``scale`` times larger (1 x 1 maps, the image pool's,
    stay 1 x 1)."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(tuple(a[0].shape)))
             for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(x, *args)
    for h in hooks:
        h.remove()
    out = set()
    for _, h, w, c in seen:
        s = 1 if h == w == 1 else scale
        out.add((8 * h * s * w * s, c))
    return out


@pytest.fixture(scope="module")
def cell_shapes():
    """The BatchNorm shapes of the four cells (portbench/configs): the
    MobileNetV2 segmenter (mini head, 128), the Xception one (DeepLab head,
    256, 8 middle blocks), both at output stride 8, and the depth-8 U-Net,
    all at 512^2, batch 8."""
    torch.manual_seed(0)
    mnv2 = TextSegmenter(width_mult=1.0, output_stride=8, decoder_mid=128).eval()
    xcp = TextSegmenter(width_mult=1.0, output_stride=8, decoder_mid=256, backbone="xception",
                        head="deeplab", middle_repeats=8).eval()
    unet = InpaintUNet(depth=8).eval()
    x64 = torch.rand(1, 64, 64, 3)
    shapes = _bn_shapes(mnv2, x64, scale=8) | _bn_shapes(xcp, x64, scale=8)
    shapes |= _bn_shapes(unet, torch.rand(1, 256, 256, 3), torch.ones(1, 256, 256, 1), scale=2)
    return sorted(shapes)


RAGGED = [(1, 16), (7, 24), (263, 728), (265, 2048), (1000003, 16), (12345, 144), (999, 3),
          (4097, 40), (33, 5), (2 ** 21 + 1, 64)]


def _cu_const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m, f"{name} not found in {CSRC.name}"
    return int(m.group(1))


def test_plan_constants_match_the_source():
    assert kbn.BN_THREADS == _cu_const("BN_THREADS")
    codes = dict(re.findall(r"ACT_(\w+) = (\d+)", CSRC.read_text()))
    assert {k: str(v) for k, v in kbn._ACT_CODE.items()} == {k.lower(): v for k, v in codes.items()}


def _check_plan(rows: int, c: int, elem: int) -> kbn.BNPlan:
    p = kbn.bn_plan(rows, c, elem, SMS)
    want_vec = 16 // elem if c * elem % 16 == 0 else 1
    assert p.vec == want_vec and p.vec * elem in (16, elem)
    assert 1 <= p.threads <= kbn.BN_THREADS and p.threads == p.lanes * p.cvb
    # every channel vector in exactly one block, no empty block
    cv = c // p.vec
    assert p.cblocks * p.cvb >= cv > (p.cblocks - 1) * p.cvb
    # row blocks take rows [b rows / nb, (b + 1) rows / nb): none empty, and
    # every lane of a CTA has a row
    assert 1 <= p.row_blocks <= rows and p.lanes <= rows // p.row_blocks
    # two waves of the card (to within a CTA per channel block) where the
    # rows allow, else a row a CTA
    waves = kbn.BN_WAVES * SMS
    assert waves - p.cblocks < p.ctas <= waves or p.row_blocks == rows or p.cblocks > waves
    # the fold one SM does is small, unless the blocks are down to 128 bytes
    assert p.fold_bytes() <= kbn.BN_FOLD_BYTES or p.cvb <= kbn.BN_MIN_CV
    # shared memory without an opt-in; the fold's scratch fits in it
    assert p.smem_bytes() <= 48 * 1024
    nch = p.cvb * p.vec
    fln = p.threads // nch if p.threads >= nch else 1
    assert 2 * 4 * fln * nch <= p.smem_bytes()
    # the workspace: a slot of 2 x C floats per row block
    assert p.part_floats(c) == 2 * p.row_blocks * c
    return p


@pytest.mark.parametrize("elem", [2, 4])
def test_plan_at_the_cells_bn_shapes(cell_shapes, elem):
    cs = {c for _, c in cell_shapes}
    # the models' widths: MobileNetV2's, Xception's, both heads' and the U-Net's
    assert {16, 24, 32, 96, 144, 192, 384, 576, 960, 320, 728, 1024, 1536, 2048, 64, 128, 256,
            512, 48}.issubset(cs), sorted(cs)
    assert any(rows == 8 for rows, _ in cell_shapes)  # the image pool's 1 x 1 map
    for rows, c in cell_shapes:
        p = _check_plan(rows, c, elem)
        assert p.vec * elem == 16  # every width of the models takes 16-byte vectors


@pytest.mark.parametrize("rows,c", RAGGED)
@pytest.mark.parametrize("elem", [2, 4])
def test_plan_at_ragged_rows(rows, c, elem):
    _check_plan(rows, c, elem)


def test_plan_of_xceptions_middle_flow():
    """(8, 64, 64, 728) bf16: 91 vectors of 16 bytes in 5 blocks of 19 (the
    last 15), 26 lanes, 52 row blocks of 630 or 631 rows: 260 CTAs, a fold
    of 61.75 KiB."""
    p = kbn.bn_plan(8 * 64 * 64, 728, 2, SMS)
    assert (p.vec, p.cvb, p.cblocks, p.lanes, p.row_blocks) == (8, 19, 5, 26, 52)
    assert p.ctas == 260 and p.fold_bytes() == 63232


def _modules(c: int, seed: int = 0, device="cpu"):
    """Two BatchNorms with the same random affine and running statistics."""
    g = torch.Generator().manual_seed(seed)
    a = BatchNorm(c)
    with torch.no_grad():
        a.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
        a.bias.copy_(0.5 * torch.randn(c, generator=g))
        a.running_mean.copy_(0.2 * torch.randn(c, generator=g))
        a.running_var.copy_(0.5 + torch.rand(c, generator=g))
    b = BatchNorm(c)
    b.load_state_dict(a.state_dict())
    return a.to(device), b.to(device)


def _x(shape, seed, dtype=torch.float32, device="cpu", shift=0.3):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 1.7 + shift).to(dtype).to(device)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_plain_route_is_bn_then_the_activation(act, dtype, mode):
    a, b = _modules(24)
    for m in (a, b):
        m.train(mode != "eval")
    x = _x((2, 5, 3, 24), 1, dtype)
    fz = mode == "frozen"
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = a(xa, frozen=fz, act=act)
    yb = _ACTS[act](b(xb, frozen=fz))
    assert ya.dtype == dtype
    assert torch.equal(ya, yb)
    dy = _x(x.shape, 2, dtype)
    ya.backward(dy)
    yb.backward(dy)
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(a.weight.grad, b.weight.grad) and torch.equal(a.bias.grad, b.bias.grad)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k


def test_plain_route_counts_and_refuses_an_unknown_activation():
    a, _ = _modules(16)
    before = counters()
    a(_x((2, 3, 3, 16), 0))
    a.eval()
    a(_x((2, 3, 3, 16), 0).double())
    after = counters()
    assert after.get("bn.plain", 0) - before.get("bn.plain", 0) == 2
    assert after.get("bn.kernel", 0) == before.get("bn.kernel", 0)
    with pytest.raises(ValueError, match="unknown activation"):
        a(_x((2, 3, 3, 16), 0), act="selu")


def _round(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype).float()


def _emulate(x, w, b, rm, rv, dy, act, batch_stats, eps=1e-5):
    """The kernels' arithmetic in torch f32 ops (each op rounded once, as
    the kernels' __f*_rn and the eager chain round): (y, dx, dw, db)."""
    dtype = x.dtype
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    g_ = dy.float().reshape(-1, c)
    m_rows = xf.shape[0]
    if batch_stats:
        # the plain chain's moments, so that both clamp the same channels
        mean, mean2 = xf.mean(0), (xf * xf).mean(0)
        raw = mean2 - mean * mean
        var, kept = raw.clamp(min=0.0), (raw >= 0).float()
    else:
        mean, var, kept = rm, rv, torch.ones(c)
    rstd = torch.rsqrt(var + eps)
    scale = rstd * w
    z = (xf - mean) * scale + b
    zr = _round(z, dtype)
    if act == "relu":
        y, g = torch.where(zr <= 0, 0.0, zr), torch.where(zr <= 0, 0.0, g_)
    elif act == "relu6":
        y = torch.where(zr < 0, 0.0, torch.where(zr > 6, 6.0, zr))
        g = torch.where((zr >= 0) & (zr <= 6), g_, 0.0)
    elif act == "leaky":
        y = torch.where(zr > 0, zr, _round(zr * 0.2, dtype))
        g = torch.where(zr > 0, g_, _round(g_ * 0.2, dtype))
    else:
        y, g = zr, g_
    sg = g.sum(0)
    sgx = (g * (xf - mean)).sum(0) * rstd
    if batch_stats:
        ga, gb = sg / m_rows, kept * rstd * (sgx / m_rows)
        dx = scale * (g - ga - (xf - mean) * gb)
    else:
        dx = scale * g
    return (y.to(dtype).reshape(x.shape), dx.to(dtype).reshape(x.shape), sgx, sg)


def _tol(dtype, ref: torch.Tensor) -> torch.Tensor:
    """One step of dtype at |ref| plus 1e-3 (bf16) or 1e-5 (f32) of max |ref|."""
    ref = ref.float()
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    floor = 1e-3 if dtype == torch.bfloat16 else 1e-5
    return step * ref.abs() + floor * ref.abs().max()


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["train", "frozen"])
def test_emulated_kernels_match_autograd_of_the_plain_chain(act, dtype, mode):
    c = 24
    a, _ = _modules(c, seed=3)
    x = _x((4, 6, 5, c), 4, dtype)
    # a constant channel: in f32 one whose variance the chain clamps
    # (E[x^2] < E[x]^2 as rounded); bf16's squares are exact, its variance 0
    x[..., 5] = 0.0411 if dtype == torch.float32 else 0.75
    xf = x[..., 5].float()
    assert ((xf * xf).mean() - xf.mean() * xf.mean() < 0) == (dtype == torch.float32)
    dy = _x(x.shape, 5, dtype, shift=0.0)
    w, b = a.weight.detach().clone(), a.bias.detach().clone()
    rm, rv = a.running_mean.clone(), a.running_var.clone()
    batch = mode == "train"
    y_e, dx_e, dw_e, db_e = _emulate(x, w, b, rm, rv, dy, act, batch)
    xr = x.clone().requires_grad_()
    y = a(xr, frozen=not batch, act=act)
    y.backward(dy)
    for name, got, want in (("y", y_e, y.detach()), ("dx", dx_e, xr.grad),
                            ("dw", dw_e, a.weight.grad), ("db", db_e, a.bias.grad)):
        t = dtype if name in ("y", "dx") else torch.float32
        err = (got.float() - want.float()).abs()
        assert (err <= _tol(t, want) + 1e-6).all(), (name, err.max().item())


def _bn_acts(model) -> dict:
    """The activation each BatchNorm of ``model`` should be handed: its
    ConvBNAct's where the kernels fuse it, relu and leaky in the U-Net's
    encoder and decoder, else none."""
    from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import ConvBNAct

    want = {id(m): "none" for m in model.modules() if isinstance(m, BatchNorm)}
    for m in model.modules():
        if isinstance(m, ConvBNAct):
            want[id(m[1])] = m.act if m.act in kbn.FUSED_ACTS else "none"
        elif isinstance(m, InpaintUNet):
            want.update({id(b): "relu" for b in m.enc_bns if isinstance(b, BatchNorm)})
            want.update({id(b): "leaky" for b in m.dec_bns})
    return want


@pytest.mark.parametrize("name", ["mobilenet_v2", "xception", "unet"])
def test_each_models_batchnorm_calls_count_once_with_their_activation(name):
    """On the CPU every BatchNorm call of the cells' models, a training
    forward and backward, counts once as ``bn.plain`` and never as
    ``bn.kernel``, and is handed the activation that follows it."""
    torch.manual_seed(0)
    if name == "unet":
        model, args = InpaintUNet(depth=4), (torch.rand(2, 32, 32, 3), torch.ones(2, 32, 32, 1))
    else:
        kw = {"backbone": "xception", "head": "deeplab", "middle_repeats": 1} if name == "xception" else {}
        model, args = TextSegmenter(width_mult=0.35, output_stride=8, **kw), (torch.rand(2, 32, 32, 3),)
    model.train()
    want, seen = _bn_acts(model), []
    hooks = [m.register_forward_hook(
        lambda m, a, kw, y: seen.append(kw.get("act", "none") == want[id(m)]), with_kwargs=True)
        for m in model.modules() if isinstance(m, BatchNorm)]
    before = counters()
    model(*args).float().square().mean().backward()
    after = counters()
    for h in hooks:
        h.remove()
    assert seen and all(seen)
    assert after.get("bn.plain", 0) - before.get("bn.plain", 0) == len(seen)
    assert after.get("bn.kernel", 0) == before.get("bn.kernel", 0)


# --- on the card -------------------------------------------------------------

gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _run(m, x, dy, act, frozen=False):
    m.weight.grad = m.bias.grad = None
    xr = x.clone().requires_grad_()
    y = m(xr, frozen=frozen, act=act)
    y.backward(dy)
    return y.detach(), xr.grad, m.weight.grad, m.bias.grad


def _plain(m, x, dy, act, frozen=False):
    m.weight.grad = m.bias.grad = None
    xr = x.clone().requires_grad_()
    y = kbn.batchnorm_plain(xr, m.weight, m.bias, m.running_mean, m.running_var,
                            m.num_batches_tracked, batch_stats=m.training and not frozen,
                            eps=m.eps, act=act)
    y.backward(dy)
    return y.detach(), xr.grad, m.weight.grad, m.bias.grad


def _close(name, dtype, got, want, extra=0.0):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    err = (got.float() - want.float()).abs()
    bad = err > _tol(dtype, want) + 1e-6 + extra
    assert not bad.any(), (f"{name}: {int(bad.sum())} of {bad.numel()} off, max "
                           f"{err.max().item():.3g} at |want| max {want.abs().max().item():.3g}")


def _compare(dev, shape, dtype, act, mode, *, const_channel=None, noncontig=False, seed=0):
    c = shape[-1]
    k, p = _modules(c, seed=seed, device=dev)
    for m in (k, p):
        m.train(mode != "eval")
    x = _x(shape, seed + 1, dtype, dev)
    if const_channel is not None:
        x[..., const_channel] = 1.25
    dy = _x(shape, seed + 2, dtype, dev, shift=0.0)
    if noncontig:  # a (N, W, H, C) tensor seen as (N, H, W, C)
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
        assert not x.is_contiguous()
    launches, kern = kbn.BN_LAUNCHES, counters().get("bn.kernel", 0)
    got = _run(k, x, dy, act, frozen=mode == "frozen")
    torch.cuda.synchronize()
    want = _plain(p, x, dy, act, frozen=mode == "frozen")
    batch = mode == "train"
    assert kbn.BN_LAUNCHES - launches == (4 if batch else 3)
    assert counters().get("bn.kernel", 0) - kern == 1
    # dweight = rstd Sum g (x - mean): a mean one f32 step apart moves it by
    # rstd |mean| 2^-23 Sum |g|, large where the variance is small
    xf, gf = x.float().reshape(-1, c), dy.float().reshape(-1, c).abs()
    rstd = torch.rsqrt(xf.var(0, unbiased=False) + k.eps)
    cond = 4 * 2.0 ** -23 * rstd * xf.mean(0).abs() * gf.sum(0)
    for name, g, w, t, e in zip(("y", "dx", "dweight", "dbias"), got, want,
                                (dtype, dtype, torch.float32, torch.float32), (0, 0, cond, 0)):
        _close(name, t, g, w, e)
    _close("running_mean", torch.float32, k.running_mean, p.running_mean)
    _close("running_var", torch.float32, k.running_var, p.running_var)
    assert torch.equal(k.num_batches_tracked, p.num_batches_tracked)
    return k, x, dy


@gpu
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_kernels_match_the_plain_chain(cuda, act, dtype, mode):
    _compare(cuda, (4, 20, 24, 144), dtype, act, mode, const_channel=7)


@gpu
@pytest.mark.parametrize("c", [16, 24, 144, 728, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_at_the_models_widths(cuda, c, dtype):
    # rows 2 * 37 * 29 = 2146: no multiple of a CTA's rows
    _compare(cuda, (2, 37, 29, c), dtype, "relu", "train", const_channel=c - 1)


@gpu
@pytest.mark.parametrize("shape", [(1, 1, 1, 40), (3, 7, 11, 5), (8, 1, 1, 256), (1, 3, 3, 12)])
def test_kernels_at_ragged_shapes(cuda, shape):
    for dtype in (torch.bfloat16, torch.float32):
        _compare(cuda, shape, dtype, "leaky", "train")


@gpu
def test_kernels_take_a_noncontiguous_input(cuda):
    _compare(cuda, (2, 12, 16, 64), torch.bfloat16, "relu6", "train", noncontig=True)


@gpu
def test_eval_forward_is_one_launch_and_runs_are_bit_identical(cuda):
    k, x, dy = _compare(cuda, (8, 32, 32, 96), torch.bfloat16, "relu6", "train")
    a = _run(k, x, dy, "relu6")
    b = _run(k, x, dy, "relu6")
    for u, v in zip(a, b):  # the same bits run to run: no float atomics
        assert torch.equal(u, v)
    k.eval()
    with torch.no_grad():
        n = kbn.BN_LAUNCHES
        y1 = k(x, act="relu6")
        y2 = k(x, act="relu6")
        assert kbn.BN_LAUNCHES - n == 2
    assert torch.equal(y1, y2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@gpu
def test_two_ranks_on_one_card_take_the_global_batchs_statistics(cuda, tmp_path):
    rng = np.random.default_rng(7)
    c = 48
    inputs = {"x": (rng.standard_normal((8, 6, 10, c)) * 1.5 + 0.4).astype(np.float32),
              "dy": rng.standard_normal((8, 6, 10, c)).astype(np.float32),
              "acts": ACTS, "bn_state": _modules(c, seed=11)[0].state_dict()}
    inputs["x"][:4] *= 0.3  # halves that differ: per-rank statistics would miss
    torch.save(inputs, tmp_path / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), "bn", str(r), "2", str(port),
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    ranks = [torch.load(tmp_path / f"bn_{r}.pt", weights_only=False) for r in range(2)]
    for dtype in (torch.bfloat16, torch.float32):
        for act in ACTS:
            key = (str(dtype), act)
            m, _ = _modules(c, seed=11, device=cuda)
            m.train()
            x = torch.from_numpy(inputs["x"]).to(cuda, dtype)
            dy = torch.from_numpy(inputs["dy"]).to(cuda, dtype)
            y, dx, dw, db = _plain(m, x, dy, act)
            r0, r1 = ranks[0][key], ranks[1][key]
            assert r0["launches"] == r1["launches"] == 4 and r0["kernel_calls"] == 1
            _close(f"{key} y", dtype, torch.cat([r0["y"], r1["y"]]).to(cuda), y)
            _close(f"{key} dx", dtype, torch.cat([r0["dx"], r1["dx"]]).to(cuda), dx)
            _close(f"{key} dweight", torch.float32, (r0["dw"] + r1["dw"]).to(cuda), dw)
            _close(f"{key} dbias", torch.float32, (r0["db"] + r1["db"]).to(cuda), db)
            for name in ("running_mean", "running_var"):
                assert torch.equal(r0[name], r1[name])
                _close(f"{key} {name}", torch.float32, r0[name].to(cuda), getattr(m, name))
