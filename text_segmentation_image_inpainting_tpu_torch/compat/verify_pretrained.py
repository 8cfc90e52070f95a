"""The pretrained-weight runbook: one command that checks that torchvision
``vgg16`` and ``mobilenet_v2`` files drop into the port.

    python -m text_segmentation_image_inpainting_tpu_torch.compat.verify_pretrained \\
        --vgg16 vgg16.pth --mobilenet mobilenet_v2.pth [--eval] [--finetune N] \\
        [--device cuda|cpu]

Counterpart of ``tools/verify_pretrained.py``, with its flags and its
verdict, plus ``--device``: the first CUDA device (the default; a host
without CUDA is an error) or ``cpu``. For each file given it

  1. renames the file into the port's names (``compat/torchvision.py``)
     and loads it tolerantly. Coverage gates: nothing unfilled, nothing
     skipped for its shape and, for MobileNetV2, every encoder key of a
     ``TextSegmenter`` filled. ``num_batches_tracked`` counts nowhere: it
     is no weight, and JAX's variables have no such leaf;
  2. runs the port's module (``VGG16Features`` without normalisation,
     ``MobileNetV2Encoder`` at output stride 8) at the imported weights
     on a fixed input, in float32 with TF32 off, against a plain forward
     of this module that walks the file's own torchvision names in
     float64 (``F.conv2d``, BatchNorm from the running statistics, ReLU6
     or ReLU) and never goes through the name table. Gates: each tap's
     max |error| within 1e-4 (VGG) or 5e-4 (the encoder's s2, s4 and
     out) times max(1, max |truth|). It runs only where coverage passed;
  3. with ``--eval``: the imported encoder over the trained segmenter
     snapshot ``trained/seg_synth.msgpack``, scored by
     ``train/evaluate.py --task seg`` (informational; ``{"skipped": ...}``
     when the snapshot is absent);
  4. with ``--finetune N``: the imported encoder in a fresh bf16
     ``TextSegmenter``, N steps of ``train/seg.py``'s step on the
     synthetic seg stream. Gates: encoder filled, every loss finite, the
     mean loss of the last quarter below that of the first.

``--fabricate DIR`` first writes torchvision-layout files of random
weights there (``fabricate``) and runs the chain on them: no real file is
in the repository, and the same command runs on real files with
``--vgg16``/``--mobilenet``. Prints one JSON verdict line; the exit code
is 0 only if every gate passes.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.compat.torchvision import (
    load_torch_file,
    tolerant_import,
    torchvision_mobilenet_v2_state_dict,
    vgg16_features_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.data.pipeline import make_dataset, to_device
from text_segmentation_image_inpainting_tpu_torch.models.base import (
    load_model,
    save_model,
    tolerant_merge,
)
from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import MobileNetV2Encoder
from text_segmentation_image_inpainting_tpu_torch.models.text_segmentation import TextSegmenter
from text_segmentation_image_inpainting_tpu_torch.models.vgg import VGG16Features
from text_segmentation_image_inpainting_tpu_torch.train.config import SegTrainConfig
from text_segmentation_image_inpainting_tpu_torch.train.loop import add_device_flag, resolve_device
from text_segmentation_image_inpainting_tpu_torch.train.seg import make_seg_train_step
from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

TRAINED_SEG = Path(__file__).resolve().parents[2] / "trained" / "seg_synth.msgpack"
TOL_VGG, TOL_ENCODER = 1e-4, 5e-4
BN_EPS = 1e-5

# torchvision's own description of the two files: mobilenet_v2's
# inverted_residual_setting (t, c, n, s) and vgg16's features
# configuration "D". The plain forwards and the fabrication read these,
# never the port's models.
TV_MOBILENET_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
TV_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
                512, 512, 512, "M")


# -- the files' layouts and their fabrication ---------------------------------

def _bn_layout(shapes: dict, prefix: str, c: int) -> None:
    for s in ("weight", "bias", "running_mean", "running_var"):
        shapes[f"{prefix}.{s}"] = (c,)
    shapes[f"{prefix}.num_batches_tracked"] = ()


def mobilenet_v2_layout() -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of torchvision's ``mobilenet_v2()`` state_dict (width
    1.0): ``features.0..17`` (stem and blocks), ``features.18`` (the
    final 1x1 ConvBNReLU) and ``classifier.1`` (the ImageNet head)."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def cba(prefix, cin, cout, k, groups=1):
        shapes[f"{prefix}.0.weight"] = (cout, cin // groups, k, k)
        _bn_layout(shapes, f"{prefix}.1", cout)

    cba("features.0", 3, 32, 3)
    cin, feat = 32, 1
    for t, c, n, _ in TV_MOBILENET_SETTING:
        for _ in range(n):
            hidden, p, j = cin * t, f"features.{feat}.conv", 0
            if t != 1:
                cba(f"{p}.0", cin, hidden, 1)
                j = 1
            cba(f"{p}.{j}", hidden, hidden, 3, groups=hidden)
            shapes[f"{p}.{j + 1}.weight"] = (c, hidden, 1, 1)
            _bn_layout(shapes, f"{p}.{j + 2}", c)
            cin, feat = c, feat + 1
    cba("features.18", cin, 1280, 1)
    shapes["classifier.1.weight"] = (1000, 1280)
    shapes["classifier.1.bias"] = (1000,)
    return shapes


def vgg16_layout() -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of a torchvision ``vgg16()`` state_dict: every conv of
    ``features.0..28`` at its real shape, and small stand-ins for
    ``classifier.{0,3,6}`` (a real classifier's 25088 x 4096 first layer
    alone is 411 MB, and no importer reads it)."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    c, idx = 3, 0
    for v in TV_VGG16_CFG:
        if v == "M":
            idx += 1
            continue
        shapes[f"features.{idx}.weight"] = (v, c, 3, 3)
        shapes[f"features.{idx}.bias"] = (v,)
        c, idx = v, idx + 2
    for i, (cout, cin) in zip((0, 3, 6), ((64, 512), (64, 64), (1000, 64))):
        shapes[f"classifier.{i}.weight"] = (cout, cin)
        shapes[f"classifier.{i}.bias"] = (cout,)
    return shapes


def _fabricated(name: str, shape: Tuple[int, ...], gen: torch.Generator) -> torch.Tensor:
    """A random value for ``name``: He-normal conv and linear weights (so
    the 17 blocks' activations stay finite), BatchNorm scales near 1,
    positive running variances, small biases and means."""
    if name.endswith("num_batches_tracked"):
        return torch.randint(1, 10**6, (), generator=gen)
    if name.endswith("running_var"):
        return 0.5 + torch.rand(shape, generator=gen)
    w = torch.randn(shape, generator=gen)
    if len(shape) > 1:
        return w * math.sqrt(2.0 / math.prod(shape[1:]))
    if name.endswith("weight"):  # a BatchNorm scale
        return 1.0 + 0.1 * w
    return 0.1 * w


def fabricate(out_dir: str, seed: int = 0) -> Dict[str, str]:
    """Write ``vgg16.pth`` (about 59 MB) and ``mobilenet_v2.pth`` of random
    weights in torchvision's full layouts into ``out_dir``, drawn from one
    ``torch.Generator`` seeded with ``seed``. Returns their paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    made = {}
    for key, fname, layout in (("vgg16", "vgg16.pth", vgg16_layout()),
                               ("mobilenet", "mobilenet_v2.pth", mobilenet_v2_layout())):
        torch.save({k: _fabricated(k, s, gen) for k, s in layout.items()}, out / fname)
        made[key] = str(out / fname)
    return made


# -- the plain forwards over torchvision's names, in float64 ------------------

def _conv(sd, name: str, h: torch.Tensor, *, stride: int = 1, dilation: int = 1,
          groups: int = 1, bias: bool = False) -> torch.Tensor:
    w = sd[f"{name}.weight"].to(h)
    b = sd[f"{name}.bias"].to(h) if bias else None
    return F.conv2d(h, w, b, stride=stride, padding=dilation * (w.shape[-1] // 2),
                    dilation=dilation, groups=groups)


def _bn(sd, name: str, h: torch.Tensor) -> torch.Tensor:
    def per_channel(s):
        return sd[f"{name}.{s}"].to(h)[:, None, None]

    scale = torch.rsqrt(per_channel("running_var") + BN_EPS) * per_channel("weight")
    return (h - per_channel("running_mean")) * scale + per_channel("bias")


def plain_mobilenet_v2(sd: Mapping[str, torch.Tensor], x: torch.Tensor,
                       output_stride: int = 8) -> Dict[str, torch.Tensor]:
    """torchvision ``mobilenet_v2``'s features in float64, on x's device:
    x (N,H,W,3) -> taps {'s2', 's4', 'out'} (NHWC), read from the names
    ``features.{i}...`` of ``sd`` itself. A block whose stride would take
    the map past ``output_stride`` runs at stride 1 and dilates the blocks
    after it (the port's encoder's rule)."""
    def cba(name, h, **kw):
        return torch.clamp(_bn(sd, f"{name}.1", _conv(sd, f"{name}.0", h, **kw)), 0.0, 6.0)

    h = cba("features.0", x.to(torch.float64).permute(0, 3, 1, 2), stride=2)
    taps = {"s2": h}
    reached, dilation, feat = 2, 1, 1
    for t, c, n, s in TV_MOBILENET_SETTING:
        for i in range(n):
            stride, block_dilation = (s if i == 0 else 1), dilation
            if stride > 1:
                if reached >= output_stride:
                    stride, dilation = 1, dilation * s
                else:
                    reached *= stride
            p, y, j = f"features.{feat}.conv", h, 0
            if t != 1:
                y, j = cba(f"{p}.0", y), 1
            y = cba(f"{p}.{j}", y, stride=stride, dilation=block_dilation, groups=y.shape[1])
            y = _bn(sd, f"{p}.{j + 2}", _conv(sd, f"{p}.{j + 1}", y))
            h = h + y if stride == 1 and h.shape[1] == y.shape[1] else y
            feat += 1
        if c == 24:
            taps["s4"] = h
    taps["out"] = h
    return {k: v.permute(0, 2, 3, 1) for k, v in taps.items()}


def plain_vgg16(sd: Mapping[str, torch.Tensor], x: torch.Tensor,
                taps: int = 3) -> List[torch.Tensor]:
    """torchvision ``vgg16``'s features in float64, on x's device, without
    the ImageNet normalisation: x (N,H,W,3) -> the maps after pool1..pool
    ``taps`` (NHWC)."""
    h, out, idx = x.to(torch.float64).permute(0, 3, 1, 2), [], 0
    for v in TV_VGG16_CFG:
        if v == "M":
            h = F.max_pool2d(h, 2)
            out.append(h.permute(0, 2, 3, 1))
            idx += 1
            if len(out) == taps:
                break
        else:
            h = F.relu(_conv(sd, f"features.{idx}", h, bias=True))
            idx += 2
    return out


# -- the gates ----------------------------------------------------------------

def coverage_counts(report: dict) -> dict:
    """``tolerant_merge``'s report as counts, without ``num_batches_tracked``."""
    return {k: sum(not n.endswith("num_batches_tracked") for n in v) for k, v in report.items()}


def _covered(counts: dict) -> bool:
    return counts["unfilled"] == 0 and counts["skipped_shape"] == 0


@contextlib.contextmanager
def _full_f32():
    """cuDNN and cuBLAS in true float32 (they take TF32 by default)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _tap_errors(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor],
                tol: float) -> Tuple[dict, bool]:
    """Each tap's max |got - want| and max |want|, and whether every error
    is within ``tol`` times max(1, max |want|)."""
    errs, truth = {}, {}
    for k, w in want.items():
        errs[k] = (got[k].double() - w).abs().max().item()
        truth[k] = w.abs().max().item()
    ok = all(errs[k] <= tol * max(1.0, truth[k]) for k in want)
    return {"tap_max_abs_err": errs, "tap_max_abs_truth": truth}, ok


def _fixed_input(size: int, device: torch.device) -> torch.Tensor:
    x = np.random.default_rng(0).random((1, size, size, 3)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def encoder_unfilled(report: dict) -> List[str]:
    return [k for k in report["unfilled"]
            if k.startswith("encoder.") and not k.endswith("num_batches_tracked")]


def verify_vgg16(path: str, size: int, device: torch.device) -> dict:
    """Coverage and parity of a torchvision ``vgg16`` file in
    ``VGG16Features``."""
    sd = load_torch_file(path)
    vgg = VGG16Features(normalize=False).to(device)
    counts = coverage_counts(tolerant_import(vgg, vgg16_features_state_dict(sd)))
    out = {"coverage": counts, "tap_max_abs_err": None, "tol": TOL_VGG}
    ok = _covered(counts)
    if ok:
        x = _fixed_input(size, device)
        with torch.no_grad(), _full_f32():
            got = vgg(x)
            want = plain_vgg16(sd, x)
        names = [f"pool{i + 1}" for i in range(len(want))]
        taps, ok = _tap_errors(dict(zip(names, got)), dict(zip(names, want)), TOL_VGG)
        out.update(taps)
    return {"ok": bool(ok), **out}


def verify_mobilenet(path: str, size: int, device: torch.device) -> dict:
    """Coverage and parity of a torchvision ``mobilenet_v2`` file in
    ``MobileNetV2Encoder(1.0, 8)``, and its coverage of a
    ``TextSegmenter``'s encoder."""
    sd = load_torch_file(path)
    enc = MobileNetV2Encoder(width_mult=1.0, output_stride=8).to(device).eval()
    counts = coverage_counts(tolerant_import(enc, torchvision_mobilenet_v2_state_dict(sd)))
    _, seg_report = tolerant_merge(TextSegmenter(width_mult=1.0, output_stride=8).state_dict(),
                                   torchvision_mobilenet_v2_state_dict(sd, prefix="encoder."))
    enc_unfilled = encoder_unfilled(seg_report)
    out = {"coverage": counts, "segmenter_encoder_unfilled": enc_unfilled[:5],
           "tap_max_abs_err": None, "tol": TOL_ENCODER}
    ok = _covered(counts) and not enc_unfilled
    if ok:
        x = _fixed_input(size, device)
        with torch.no_grad(), _full_f32():
            got = enc(x)
            want = plain_mobilenet_v2(sd, x)
        taps, ok = _tap_errors(got, want, TOL_ENCODER)
        out.update(taps)
    return {"ok": bool(ok), **out}


def eval_with_encoder(path: str, size: int, batches: int, device: torch.device) -> dict:
    """``train/evaluate.py --task seg`` with the imported encoder merged
    over the trained segmenter snapshot (informational: a decoder trained
    against another encoder)."""
    from text_segmentation_image_inpainting_tpu_torch.train import evaluate

    if not TRAINED_SEG.exists():
        return {"skipped": f"no trained snapshot at {TRAINED_SEG}"}
    seg = load_model(str(TRAINED_SEG), TextSegmenter())
    tolerant_import(seg, torchvision_mobilenet_v2_state_dict(load_torch_file(path),
                                                             prefix="encoder."))
    with tempfile.TemporaryDirectory() as tmp:
        snap = str(Path(tmp) / "seg.pt")
        save_model(snap, seg)
        with contextlib.redirect_stdout(io.StringIO()):  # the verdict is the one line
            return evaluate.main(["--task", "seg", "--seg-ckpt", snap, "--size", str(size),
                                  "--batches", str(batches), "--device", device.type])


def finetune_smoke(path: str, steps: int, size: int, batch: int, device: torch.device) -> dict:
    """The imported encoder in a fresh ``TextSegmenter`` (bf16 compute, the
    seg trainer's default), ``steps`` train steps on ``make_dataset("seg",
    seed=0)``. ``ms_per_step``: host clock over the steps after the first
    (which warms up), the batch draw included; ``draw_ms_per_step``: the
    host's share of it that draws and uploads the batch."""
    cfg = SegTrainConfig(image_size=(size, size), batch_size=batch)
    model = TextSegmenter(
        width_mult=cfg.width_mult, output_stride=cfg.output_stride, decoder_mid=cfg.decoder_mid,
        dtype=torch.bfloat16 if cfg.bf16_compute else torch.float32,
    ).init_weights(torch.Generator().manual_seed(0))
    report = tolerant_import(model, torchvision_mobilenet_v2_state_dict(load_torch_file(path),
                                                                        prefix="encoder."))
    enc_unfilled = encoder_unfilled(report)
    state = create_train_state(model.to(device), cfg.optimizer)
    step = make_seg_train_step(model, cfg)
    it = make_dataset("seg", batch_size=batch, size=cfg.image_size, seed=0)
    totals, draw = [], 0.0
    for i in range(steps):
        t = time.perf_counter()
        pages = to_device(next(it), device)
        draw += time.perf_counter() - t
        state, metrics = step(state, pages)
        totals.append(metrics["total"].detach().float())
        if i == 0:
            totals[0].item()  # wait for the first step, then time the rest
            t0, draw = time.perf_counter(), 0.0
    totals = torch.stack(totals).cpu().tolist()
    timed = steps - 1
    ms = (time.perf_counter() - t0) * 1e3 / timed if timed else None
    draw_ms = draw * 1e3 / timed if timed else None
    q = max(1, steps // 4)
    first_q, last_q = float(np.mean(totals[:q])), float(np.mean(totals[-q:]))
    ok = not enc_unfilled and all(np.isfinite(totals)) and last_q < first_q
    return {"ok": bool(ok), "steps": steps, "size": size, "batch": batch,
            "encoder_unfilled": enc_unfilled[:5], "loss_first_quarter": first_q,
            "loss_last_quarter": last_q, "loss_final": totals[-1], "ms_per_step": ms,
            "draw_ms_per_step": draw_ms}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--vgg16", type=str, default=None, help="torchvision vgg16 .pth")
    p.add_argument("--mobilenet", type=str, default=None, help="torchvision mobilenet_v2 .pth")
    p.add_argument("--fabricate", type=str, default=None, metavar="DIR",
                   help="first write torchvision-layout files of random weights into DIR and "
                        "run the chain on those")
    p.add_argument("--size", type=int, default=64, help="parity input size")
    p.add_argument("--eval", action="store_true",
                   help="also score the imported encoder over the trained segmenter snapshot")
    p.add_argument("--eval-size", type=int, default=512)
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--finetune", type=int, default=0, metavar="N",
                   help="fine-tune a segmenter with the imported encoder for N steps and gate "
                        "on the loss falling")
    p.add_argument("--finetune-size", type=int, default=128)
    p.add_argument("--finetune-batch", type=int, default=4)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.fabricate:
        made = fabricate(args.fabricate)
        args.vgg16 = args.vgg16 or made["vgg16"]
        args.mobilenet = args.mobilenet or made["mobilenet"]
    if not args.vgg16 and not args.mobilenet:
        p.error("provide --vgg16 and/or --mobilenet (or --fabricate DIR)")

    verdict: dict = {"device": torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"}
    if args.vgg16:
        verdict["vgg16"] = verify_vgg16(args.vgg16, args.size, device)
    if args.mobilenet:
        verdict["mobilenet_v2"] = verify_mobilenet(args.mobilenet, args.size, device)
        if args.eval:
            verdict["heldout_eval"] = eval_with_encoder(args.mobilenet, args.eval_size,
                                                        args.eval_batches, device)
        if args.finetune:
            verdict["finetune_smoke"] = finetune_smoke(args.mobilenet, args.finetune,
                                                       args.finetune_size, args.finetune_batch,
                                                       device)
    verdict["ok"] = all(v.get("ok", True) for v in verdict.values() if isinstance(v, dict))
    print(json.dumps(verdict))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
