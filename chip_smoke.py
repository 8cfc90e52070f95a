#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``text_segmentation_image_inpainting_tpu_torch``'s page pipeline
(segment -> dilate -> inpaint) at full width: MobileNetV2 segmenter at
width 1.0, the depth-8 partial-conv U-Net, bf16, a batch of eight
512x512 pages, weights from a seeded ``torch.Generator``. Phases, each
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
  5. timing   CUDA events, median of 20 after warm-up: each kernel against
              its plain version per shape, and ``run`` in pages/s; then
              torch.profiler over three ``run`` calls: the device's busy
              share and the kernels that take the most time

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
CSRC = "text_segmentation_image_inpainting_tpu_torch/csrc/partial_conv.cu"
TPU_KERNEL = "text_segmentation_image_inpainting_tpu/ops/pallas/partial_conv_kernel.py"

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


def cuda_ms(fn) -> float:
    """Median milliseconds of ``fn`` over ITERS runs, after WARMUP runs."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
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

    # 5. timing -------------------------------------------------------------
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
    profile_run(run)

    kernels = []
    for kname, line, fn in (("K1", 184, "pconv_k1"), ("K2", 415, "pconv_k2")):
        ms, plain_ms, err, n = totals[kname]
        log(f"{kname}: {n} shape(s), ms and plain_ms are sums over them (one U-Net forward)")
        kernels.append({
            "name": f"{kname} {fn}", "route": "cuda", "source": CSRC,
            "replaces": f"{TPU_KERNEL}:{line}", "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def profile_run(fn, runs: int = 3) -> None:
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
    log(f"profile run: wall {wall_ms:.3f} ms per call with the profiler on, device busy "
        f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.1%}")
    for e in kernels[:15]:
        log(f"  profile: {e.self_device_time_total / 1e3 / runs:8.3f} ms {e.count / runs:5.0f}x "
            f"{e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
