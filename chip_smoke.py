#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``text_segmentation_image_inpainting_tpu_torch``'s two main paths
at full width: the page pipeline (segment -> dilate -> inpaint:
MobileNetV2 segmenter at width 1.0, the depth-8 partial-conv U-Net, bf16,
a batch of eight 512x512 pages) and the inpainting trainer (the same
U-Net in training mode, the VGG16 perceptual/style loss with the fused
stem, Adam), weights from a seeded ``torch.Generator``. Phases, each
printing its lines before the last:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds csrc/*.cu into the package's _build/ directory
  3. parity   K1 and K2 against their plain PyTorch version at the eight
              shapes the U-Net gives them, on the card
  4. pipeline ``run`` and ``inpaint`` once each with the launch counters
              reset: K1 must run 7 times and K2 once per U-Net forward;
              outputs finite, masks binary, non-text pixels bit-identical
              to the input; every stride-1 partial conv's real inputs,
              caught by forward hooks, re-run through the plain version
  5. train    K3 (the partial conv's backward) against autograd of the
              plain version at the 8 shapes; K4 (the VGG stem's dx) and K5
              (its pooled forward) against their plain versions at the
              train shapes; then three train steps at depth 8, 512^2,
              batch 8, bf16, fused stem, with the launch counters reset
              before each: K1 7, K2 1, K4 1 and K5 1 per step, every loss
              term finite, every U-Net gradient finite and the decoder's and
              head's nonzero, parameters and decoder BN statistics moved,
              and with ``freeze_bn`` (the third step) the encoder's not
  6. timing   CUDA events, median after warm-up: each kernel against
              its plain version per shape, ``run`` in pages/s, the train
              step in pages/s; then torch.profiler over ``run`` and over a
              train step: the device's busy share and the kernels that
              take the most time

The last line is ``{"ok": true, "device": {...}}``; the one before it
lists the kernels. Any failed check raises: the script then exits
nonzero and prints no result. Without a CUDA device, or run away from
the repository, it exits nonzero as well.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 8
PAGE = 512
SEED = 0
ITERS = 20
WARMUP = 3
TRAIN_ITERS = 5
CSRC = "text_segmentation_image_inpainting_tpu_torch/csrc/partial_conv.cu"
CSRC_STEM = "text_segmentation_image_inpainting_tpu_torch/csrc/vgg_stem.cu"
TPU_KERNEL = "text_segmentation_image_inpainting_tpu/ops/pallas/partial_conv_kernel.py"
TPU_STEM_BWD = "text_segmentation_image_inpainting_tpu/ops/pallas/vgg_stem_bwd.py"
TPU_STEM = "text_segmentation_image_inpainting_tpu/ops/pallas/vgg_stem.py"

# The stride-1 partial convs of InpaintUNet(depth=8) at 512^2 pages:
# (layer, H = W, C_lo, C_skip, Cout). Decoder levels have no bias; the
# head (Cout 3) has one.
SHAPES = (
    ("dec7", 4, 512, 512, 512),
    ("dec6", 8, 512, 512, 512),
    ("dec5", 16, 512, 512, 512),
    ("dec4", 32, 512, 512, 512),
    ("dec3", 64, 512, 256, 256),
    ("dec2", 128, 256, 128, 128),
    ("dec1", 256, 128, 64, 64),
    ("head", 512, 64, 3, 3),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def hole_mask(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w) float32, 1 = valid: random disks and rectangles as holes."""
    m = np.ones((n, h, w), np.float32)
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        for _ in range(int(rng.integers(2, 7))):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(0.02, 0.12) * max(h, w) + 0.5
            m[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 0
        for _ in range(int(rng.integers(1, 3))):
            rh, rw = int(rng.uniform(0.05, 0.25) * h) + 1, int(rng.uniform(0.05, 0.25) * w) + 1
            y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
            m[i, y : y + rh, x : x + rw] = 0
    return m


def grouped_mask(rng, n, h, w, device) -> torch.Tensor:
    """(n, h, w, 2) bf16 as the decoder sees it: group 0 the nearest-x2
    upsampled mask of the level below, group 1 the skip's own mask. Both
    are zero on a 3x3 corner of page 0, so windows with no valid tap at
    all are always present."""
    lo = hole_mask(rng, n, max(h // 2, 1), max(w // 2, 1))
    lo = lo.repeat(2, axis=1).repeat(2, axis=2)[:, :h, :w]
    m = np.stack([lo, hole_mask(rng, n, h, w)], axis=-1)
    m[0, :3, :3, :] = 0
    return torch.from_numpy(m).to(device=device, dtype=torch.bfloat16)


def check_close(name: str, got, want, *, require_empty: bool = False) -> float:
    """A kernel's (y, M') against its plain version's. M' must be equal bit
    for bit, and y exactly 0 wherever M' is 0 (with ``require_empty``,
    such windows must exist). Elsewhere both sides
    accumulate in f32 in different orders and round once to bf16, so a
    rounding boundary may fall between them: |dy| <= 2^-7 |y_plain| (one
    bf16 step) + 1e-3 max |y_plain| (the f32 order difference, scaled by
    the renormalisation). Returns max |dy|."""
    y, m = got
    y_ref, m_ref = want
    if not torch.equal(m, m_ref):
        raise AssertionError(f"{name}: M' differs in {int((m != m_ref).sum())} pixels")
    if not torch.isfinite(y).all():
        raise AssertionError(f"{name}: non-finite output")
    empty = m[..., 0] == 0
    if require_empty and int(empty.sum()) == 0:
        raise AssertionError(f"{name}: no empty window in the test input")
    if not (y[empty] == 0).all():
        raise AssertionError(f"{name}: nonzero output in an empty window")
    y, y_ref = y.float(), y_ref.float()
    err = (y - y_ref).abs()
    bound = 2.0**-7 * y_ref.abs() + 1e-3 * y_ref.abs().max()
    if not (err <= bound).all():
        raise AssertionError(
            f"{name}: |dy| up to {err.max().item():.4g} exceeds the bound "
            f"(max |y| {y_ref.abs().max().item():.4g})"
        )
    return err.max().item()


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def check_grads(name, x, mask, w, b, g, kw) -> float:
    """K3: dx, dW, db of the kernel path (bf16, the weights as the U-Net
    passes them) against autograd of the plain version in f32 from the
    same bf16 values. Both sides accumulate in f32; the kernel path rounds
    dacc, dx and dW to bf16 once each, so each gradient must be within 1%
    in relative L2 and 2^-5 of its max |value| everywhere. Returns the
    largest relative L2."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    bf = torch.bfloat16
    leaves = [x.detach().to(bf).requires_grad_(True), w.detach().to(bf).requires_grad_(True)]
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    if b is not None:
        leaves.append(b.detach().to(bf).requires_grad_(True))
        ref_leaves.append(leaves[-1].detach().float().requires_grad_(True))
    bias, ref_bias = (leaves[2], ref_leaves[2]) if b is not None else (None, None)
    y, _ = kpc.partial_conv2d_fused(leaves[0], mask, leaves[1], bias, **kw)
    got = torch.autograd.grad(y, leaves, g)
    y_ref, _ = kpc.partial_conv2d_reference(ref_leaves[0], mask.float(), ref_leaves[1], ref_bias,
                                            **kw)
    want = torch.autograd.grad(y_ref, ref_leaves, g.float())
    worst = 0.0
    for what, a, r in zip(("dx", "dW", "db"), got, want):
        a = a.float()
        rel, err = rel_l2(a, r), (a - r).abs().max().item()
        if not torch.isfinite(a).all() or rel > 1e-2 or err > 2**-5 * r.abs().max().item():
            raise AssertionError(f"{name} {what}: relative L2 {rel:.3g}, max |d| {err:.4g} "
                                 f"(max |ref| {r.abs().max().item():.4g})")
        worst = max(worst, rel)
    return worst


def check_stem_dx(name, x, g, w0, b0, w1, b1, *, compare_max: bool = True) -> dict:
    """K4 against the f32 truth: the plain dx in f32 from the same bf16
    inputs and bf16-rounded weights. The bf16 cuDNN autograd stem is held
    to the same truth, and K4 must be no worse (as
    tests/test_vgg_stem_bwd.py holds the Pallas kernel to XLA's bf16
    backward): its relative L2 within max(1.5 x cuDNN's, 1e-3) and, with
    ``compare_max``, its max |error| within 1.5 x cuDNN's. Both bf16
    backwards route a 2x2 pool tie wherever their own rounding puts the
    max, so neither is exact; the 1.5 is the JAX test's margin for that.
    The max is a fair comparison only over many windows (the train
    shape): on a small page one tie routed differently sets it."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs

    got = kvs.stem_dx(x, g, w0, b0, w1, b1)
    plain = kvs.stem_dx_reference(x, g, w0, b0, w1, b1)
    rb = [t.to(torch.bfloat16).float() for t in (w0, b0, w1, b1)]
    truth = kvs.stem_dx_reference(x.float(), g.float(), *rb)
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or got.shape != x.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: dx {got.dtype} {tuple(got.shape)} or non-finite")
    res = {"rel": rel_l2(got, truth), "rel_cudnn": rel_l2(plain, truth),
           "max": (got - truth).abs().max().item(), "max_cudnn": (plain.float() - truth).abs().max().item()}
    if res["rel"] > max(1.5 * res["rel_cudnn"], 1e-3) or (
            compare_max and res["max"] > 1.5 * res["max_cudnn"]):
        raise AssertionError(f"{name}: K4 is further from the f32 truth than the bf16 cuDNN stem: {res}")
    return res


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    # 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import _partial_conv2d_plain
    from text_segmentation_image_inpainting_tpu_torch.models import PartialConv
    from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {kind}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    # the plain side computes in true f32 (cuDNN would use TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    log(f"build: nvcc {build.last_build['seconds']:.1f} s, ready in "
        f"{time.perf_counter() - t0:.1f} s: {build.last_build['path']}")
    for line in build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernel parity ------------------------------------------------------
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for name, h, c_lo, c_skip, cout in SHAPES:
        cin = c_lo + c_skip
        x = torch.randn((BATCH, h, h, cin), generator=gen, device=dev).to(torch.bfloat16)
        mask = grouped_mask(rng, BATCH, h, h, dev)
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1 if cout <= 7 else None
        kw = dict(group_sizes=(c_lo, c_skip), padding=(1, 1))
        got = kpc.partial_conv2d_fused(x, mask, w, b, **kw)
        want = kpc.partial_conv2d_reference(x, mask, w, b, **kw)
        torch.cuda.synchronize()
        err = check_close(name, got, want, require_empty=True)
        kname = "K2" if cout <= 7 else "K1"
        empty = int((got[1] == 0).sum())
        log(f"parity {kname} {name}: x {tuple(x.shape)} -> y {tuple(got[0].shape)}, "
            f"M' bit-exact, {empty} empty windows exactly 0, max|dy| {err:.4g}")
        cases.append((kname, name, x, mask, w, b, kw, err))

    # 4. pipeline -----------------------------------------------------------
    pipe = TextRemovalPipeline().init_weights(torch.Generator().manual_seed(SEED))
    pipe = pipe.to(dev).eval()
    pages = torch.from_numpy(rng.uniform(0.0, 1.0, (BATCH, PAGE, PAGE, 3)).astype(np.float32))
    pages = pages.to(dev)
    pages_c = pages.to(pipe.compute_dtype)

    calls = []

    def keep_inputs(module, args, kwargs, output):
        if module.conv.stride == (1, 1):
            calls.append((module, args[0], args[1], kwargs.get("group_sizes"), output))

    pconvs = [m for m in pipe.modules() if isinstance(m, PartialConv)]
    hooks = [m.register_forward_hook(keep_inputs, with_kwargs=True) for m in pconvs]
    kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0
    clean, text = pipe.run(pages)
    torch.cuda.synchronize()
    launches = {"K1": kpc.K1_LAUNCHES, "K2": kpc.K2_LAUNCHES}
    for hk in hooks:
        hk.remove()
    log(f"pipeline run: pages {tuple(pages.shape)} -> clean {tuple(clean.shape)} "
        f"{clean.dtype}, text mask {tuple(text.shape)}; launches {launches}")
    if launches != {"K1": 7, "K2": 1}:
        raise AssertionError(f"run launched {launches}, want K1 7 and K2 1")

    def check_page_out(what, out, text_mask):
        if out.shape != pages.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{what}: output shape {tuple(out.shape)} or non-finite values")
        if not ((text_mask == 0) | (text_mask == 1)).all():
            raise AssertionError(f"{what}: text mask not binary")
        keep = (text_mask == 0).expand_as(out)
        if not torch.equal(out[keep], pages_c[keep]):
            raise AssertionError(f"{what}: non-text pixels differ from the input page")
        frac = text_mask.float().mean().item()
        log(f"{what}: finite, binary mask ({frac:.3%} text), non-text pixels "
            f"bit-identical ({int(keep.sum())} values)")

    check_page_out("run", clean, text)
    if len(calls) != 8:
        raise AssertionError(f"caught {len(calls)} stride-1 partial convs, want 8")
    for i, (module, x, mask, gs, (y, m)) in enumerate(calls):
        c = module.conv
        want = kpc.partial_conv2d_reference(
            x, mask, c.weight.to(module.dtype),
            None if c.bias is None else c.bias.to(module.dtype),
            group_sizes=gs, padding=c.padding,
        )
        err = check_close(f"run layer {i}", (y, m), want)
        log(f"run layer {i}: x {tuple(x.shape)} groups {gs} -> {c.out_channels}: kernel == plain "
            f"on the pipeline's own inputs, max|dy| {err:.4g}")
    del calls

    holes = torch.from_numpy(hole_mask(rng, BATCH, PAGE, PAGE)[..., None]).to(dev)
    text_in = 1.0 - holes
    kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0
    inpainted = pipe.inpaint(pages, text_in)
    torch.cuda.synchronize()
    got = {"K1": kpc.K1_LAUNCHES, "K2": kpc.K2_LAUNCHES}
    if got != {"K1": 7, "K2": 1}:
        raise AssertionError(f"inpaint launched {got}, want K1 7 and K2 1")
    check_page_out("inpaint (given hole mask)", inpainted, text_in)

    # 5. train --------------------------------------------------------------
    tr = train_phase(dev, rng, cases)

    # 6. timing -------------------------------------------------------------
    totals = {"K1": [0.0, 0.0, 0.0, 0], "K2": [0.0, 0.0, 0.0, 0]}  # ms, plain ms, max err, n
    for kname, name, x, mask, w, b, kw, err in cases:
        plain = lambda: kpc.partial_conv2d_reference(x, mask, w, b, **kw)  # noqa: E731
        kern = lambda: kpc.partial_conv2d_fused(x, mask, w, b, **kw)  # noqa: E731
        twin = lambda: _partial_conv2d_plain(  # noqa: E731
            x, mask, w, b, kw["group_sizes"], (1, 1), kw["padding"], (1, 1)
        )
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        t_twin = cuda_ms(twin)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        flop = 2.0 * x.shape[0] * x.shape[1] * x.shape[2] * w.shape[0] * w.shape[1] * 9
        log(f"time {kname} {name}: kernel {k_ms:.4f} ms ({flop / k_ms / 1e9:.1f} TFLOP/s), "
            f"plain f32 {p_ms:.4f} ms, plain bf16 cuDNN {t_twin:.4f} ms")
        t = totals[kname]
        t[0] += k_ms
        t[1] += p_ms
        t[2] = max(t[2], err)
        t[3] += 1

    def run():
        pipe.run(pages)

    run_ms = cuda_ms(run)
    seg_ms = cuda_ms(lambda: pipe.segment(pages))
    inp_ms = cuda_ms(lambda: pipe.inpaint(pages, text_in))
    log(f"time run: {run_ms:.3f} ms per batch of {BATCH} = {BATCH / run_ms * 1e3:.2f} pages/s "
        f"(segment {seg_ms:.3f} ms, inpaint {inp_ms:.3f} ms)")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_run(run, "run")
    stem_times = time_train(tr)

    kernels = []
    for kname, line, fn in (("K1", 184, "pconv_k1"), ("K2", 415, "pconv_k2")):
        ms, plain_ms, err, n = totals[kname]
        log(f"{kname}: {n} shape(s), ms and plain_ms are sums over them (one U-Net forward); "
            f"launches from the pipeline run, {tr['launches'][kname]} per train step")
        kernels.append({
            "name": f"{kname} {fn}", "route": "cuda", "source": CSRC,
            "replaces": f"{TPU_KERNEL}:{line}", "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    for kname, fn, tpu in (("K4", "stem_dx", f"{TPU_STEM_BWD}:366"),
                           ("K5", "stem_pool", f"{TPU_STEM}:191")):
        ms, plain_ms = stem_times[kname]
        log(f"{kname}: launches from the first train step")
        kernels.append({
            "name": f"{kname} {fn}", "route": "cuda", "source": CSRC_STEM, "replaces": tpu,
            "launches": tr["launches"][kname], "max_abs_err": tr["err"][kname],
            "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def train_phase(dev, rng, cases) -> dict:
    """Phase 5: K3, K4 and K5 against their plain versions at the train
    shapes, then three full-width train steps (the third with
    ``freeze_bn``), each checked. Returns what the timing phase needs."""
    import dataclasses

    from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
        InpaintLossConfig,
        make_vgg,
    )
    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet
    from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import BatchNorm
    from text_segmentation_image_inpainting_tpu_torch.models.vgg import imagenet_normalize
    from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
    from text_segmentation_image_inpainting_tpu_torch.train.config import InpaintTrainConfig
    from text_segmentation_image_inpainting_tpu_torch.train.inpaint import make_inpaint_train_step
    from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    k3 = []
    for _, name, x, mask, w, b, kw, _ in cases:
        g = torch.randn((*x.shape[:3], w.shape[0]), generator=gen, device=dev).to(bf)
        rel = check_grads(f"K3 {name}", x, mask, w, b, g, kw)
        log(f"parity K3 {name}: dx, dW{', db' if b is not None else ''} against autograd of the "
            f"plain version in f32, largest relative L2 {rel:.3g}")
        k3.append((name, x, mask, w, b, kw, g))

    torch.manual_seed(SEED)  # the VGG trunk's default init
    loss_cfg = InpaintLossConfig(vgg_dtype="bfloat16", fused_stem=True)
    vgg = make_vgg(loss_cfg).to(dev)
    w0, b0 = vgg.features[0].weight, vgg.features[0].bias
    w1, b1 = vgg.features[2].weight, vgg.features[2].bias
    pages = torch.from_numpy(rng.uniform(0.0, 1.0, (BATCH, PAGE, PAGE, 3)).astype(np.float32))
    pages = pages.to(dev)
    holes = torch.from_numpy(hole_mask(rng, BATCH, PAGE, PAGE)[..., None]).to(dev)
    # the stem's input in the step: [out, comp], 2N pages, normalised, bf16
    xs = imagenet_normalize(torch.cat([pages, pages * holes])).to(bf).contiguous()
    gs = torch.randn((2 * BATCH, PAGE // 2, PAGE // 2, 64), generator=gen, device=dev).to(bf)
    res = check_stem_dx("K4 train shape", xs, gs, w0, b0, w1, b1)
    log(f"parity K4 x {tuple(xs.shape)} g {tuple(gs.shape)}: relative L2 to the f32 plain "
        f"{res['rel']:.4g} (bf16 cuDNN autograd {res['rel_cudnn']:.4g}), max |d| "
        f"{res['max']:.4g} (cuDNN {res['max_cudnn']:.4g})")
    z0 = conv2d(xs, w0, b0, padding=1).contiguous()
    got, want = kvs.stem_pool(z0, w1, b1), kvs.stem_pool_reference(z0, w1, b1)
    torch.cuda.synchronize()
    ones = torch.ones_like(want[..., :1])
    err5 = check_close("K5", (got, ones), (want, ones))
    log(f"parity K5 z0 {tuple(z0.shape)} -> {tuple(got.shape)}: max |d| {err5:.4g} "
        f"(max |y| {want.abs().max().item():.4g})")

    model = InpaintUNet(depth=8, dtype=bf).init_weights(torch.Generator().manual_seed(SEED)).to(dev)
    cfg = InpaintTrainConfig(loss=loss_cfg)
    state = create_train_state(model, cfg.optimizer)
    steps = {f: make_inpaint_train_step(model, dataclasses.replace(cfg, freeze_bn=f), vgg)
             for f in (False, True)}
    batch = {"image": pages, "mask": holes}
    grads = {}

    def keep_grads(opt, args, kwargs):
        for name, p in model.named_parameters():
            grads[name] = (p.grad is not None and bool(torch.isfinite(p.grad).all()),
                           0.0 if p.grad is None else p.grad.abs().max().item())

    hook = state.optimizer.register_step_pre_hook(keep_grads)
    enc_bns = [m for m in model.enc_bns if isinstance(m, BatchNorm)]
    stats = lambda bns: [torch.cat([m.running_mean, m.running_var]).clone() for m in bns]  # noqa: E731
    first = None
    for i, freeze in enumerate((False, False, True)):
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        enc0, dec0 = stats(enc_bns), stats(model.dec_bns)
        kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = kvs.K4_LAUNCHES = kvs.K5_LAUNCHES = 0
        state, terms = steps[freeze](state, batch)
        torch.cuda.synchronize()
        got = {"K1": kpc.K1_LAUNCHES, "K2": kpc.K2_LAUNCHES, "K4": kvs.K4_LAUNCHES,
               "K5": kvs.K5_LAUNCHES}
        first = first or got
        if got != {"K1": 7, "K2": 1, "K4": 1, "K5": 1}:
            raise AssertionError(f"train step {i} launched {got}, want K1 7, K2 1, K4 1, K5 1")
        bad = [k for k, v in terms.items() if not torch.isfinite(v)]
        not_finite = [n for n, (fin, _) in grads.items() if not fin]
        zero = [n for n, (_, mx) in grads.items() if n.startswith(("dec_", "head")) and mx == 0]
        still = [n for n, p in model.named_parameters()
                 if grads[n][1] > 0 and torch.equal(p, params[n])]
        dec_same = [j for j, (a, b) in enumerate(zip(dec0, stats(model.dec_bns))) if torch.equal(a, b)]
        enc_moved = [j for j, (a, b) in enumerate(zip(enc0, stats(enc_bns))) if not torch.equal(a, b)]
        if bad or not_finite or zero or still or dec_same or (freeze and enc_moved) or (
                not freeze and len(enc_moved) != len(enc_bns)):
            raise AssertionError(f"train step {i}: non-finite terms {bad}, grads {not_finite}, "
                                 f"zero decoder/head grads {zero}, unmoved params {still}, "
                                 f"unmoved decoder BN {dec_same}, encoder BN moved {enc_moved}")
        log(f"train step {i} (freeze_bn={freeze}): launches {got}; terms "
            + ", ".join(f"{k} {v.item():.5g}" for k, v in terms.items())
            + f"; {len(grads)} grads finite, decoder/head nonzero, params moved, decoder BN "
            f"moved, encoder BN {'unchanged' if freeze else 'moved'}")
    hook.remove()
    return {"launches": first, "err": {"K4": res["max"], "K5": err5}, "k3": k3,
            "stem": (xs, gs, w0, b0, w1, b1, z0), "step": steps[False], "state": state,
            "batch": batch}


def time_train(tr) -> dict:
    """Phase 6, train part: K3 per shape, K4, K5 and the train step.
    Returns {kernel: (ms, plain ms)} for K4 and K5."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import _partial_conv2d_plain

    bf = torch.bfloat16
    tot = [0.0, 0.0, 0.0]
    for name, x, mask, w, b, kw, g in tr["k3"]:
        wb = w.to(bf)
        bb = None if b is None else b.to(bf)

        def grad_of(fn):
            """Autograd of ``fn(x, w, b)`` with the graph built once."""
            leaves = [t.detach().requires_grad_(True) for t in (x, wb, bb) if t is not None]
            y, _ = fn(leaves[0], leaves[1], leaves[2] if bb is not None else None)
            return lambda: torch.autograd.grad(y, leaves, g, retain_graph=True)

        kern = lambda: kpc.partial_conv2d_backward(  # noqa: E731
            g, x, mask, wb, bb, kw["group_sizes"], kw["padding"])
        plain = grad_of(lambda xx, ww, bbb: kpc.partial_conv2d_reference(xx, mask, ww, bbb, **kw))
        twin = grad_of(lambda xx, ww, bbb: _partial_conv2d_plain(
            xx, mask, ww, bbb, kw["group_sizes"], (1, 1), kw["padding"], (1, 1)))
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        t_twin = cuda_ms(twin)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"time K3 {name}: backward {k_ms:.4f} ms, autograd of the plain f32 version "
            f"{p_ms:.4f} ms, autograd of the bf16 cuDNN twin {t_twin:.4f} ms")
        tot[0] += k_ms
        tot[1] += p_ms
        tot[2] += t_twin
    log(f"time K3 (sum over the 8 shapes, one U-Net backward): {tot[0]:.4f} ms, plain f32 "
        f"{tot[1]:.4f} ms, bf16 cuDNN twin {tot[2]:.4f} ms")

    xs, gs, w0, b0, w1, b1, z0 = tr["stem"]
    rb = [t.to(bf).float() for t in (w0, b0, w1, b1)]
    xf, gf = xs.float(), gs.float()
    kern = lambda: kvs.stem_dx(xs, gs, w0, b0, w1, b1)  # noqa: E731
    plain = lambda: kvs.stem_dx_reference(xs, gs, w0, b0, w1, b1)  # noqa: E731
    xr = xs.detach().requires_grad_(True)
    out = kvs.stem_forward(xr, w0, b0, w1, b1, bf)
    bwd_only = lambda: torch.autograd.grad(out, xr, gs, retain_graph=True)  # noqa: E731
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
    t_bwd = cuda_ms(bwd_only)
    t_f32 = cuda_ms(lambda: kvs.stem_dx_reference(xf, gf, *rb), iters=5, warmup=1)
    k4 = ((k1 + k2) / 2, (p1 + p2) / 2)
    flop = 2.0 * xs.shape[0] * xs.shape[1] * xs.shape[2] * 64 * 64 * 9 * 2
    log(f"time K4 x {tuple(xs.shape)}: kernel {k4[0]:.4f} ms ({flop / k4[0] / 1e9:.1f} TFLOP/s "
        f"of the two useful 64->64 products), plain bf16 cuDNN forward+backward {k4[1]:.4f} ms, "
        f"its backward alone {t_bwd:.4f} ms, plain f32 forward+backward {t_f32:.4f} ms")
    del out, xr
    kern = lambda: kvs.stem_pool(z0, w1, b1)  # noqa: E731
    plain = lambda: kvs.stem_pool_reference(z0, w1, b1)  # noqa: E731
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
    k5 = ((k1 + k2) / 2, (p1 + p2) / 2)
    flop = 2.0 * z0.shape[0] * z0.shape[1] * z0.shape[2] * 64 * 64 * 9
    log(f"time K5 z0 {tuple(z0.shape)}: kernel {k5[0]:.4f} ms ({flop / k5[0] / 1e9:.1f} TFLOP/s), "
        f"plain bf16 cuDNN {k5[1]:.4f} ms")

    step, state, batch = tr["step"], tr["state"], tr["batch"]
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(state, batch), iters=TRAIN_ITERS, warmup=2)
    log(f"time train step: {step_ms:.3f} ms per batch of {BATCH} (median of {TRAIN_ITERS}) = "
        f"{BATCH / step_ms * 1e3:.2f} training pages/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_run(lambda: step(state, batch), "train step", runs=2)
    return {"K4": k4, "K5": k5}


def profile_run(fn, label: str, runs: int = 3) -> None:
    """torch.profiler over ``runs`` calls of ``fn``: the device's busy share
    (kernel time over the window's wall time) and the kernels that take
    the most device time, per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    # kernel rows only: an aten op's row repeats the time of its kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / runs
    log(f"profile {label}: wall {wall_ms:.3f} ms per call with the profiler on, device busy "
        f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.1%}")
    for e in kernels[:15]:
        log(f"  profile: {e.self_device_time_total / 1e3 / runs:8.3f} ms {e.count / runs:5.0f}x "
            f"{e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
