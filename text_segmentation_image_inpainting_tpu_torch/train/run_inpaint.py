"""The inpainting training CLI, the port's counterpart of
``text_segmentation_image_inpainting_tpu/train/run_inpaint.py``.

    python -m text_segmentation_image_inpainting_tpu_torch.train.run_inpaint \\
        --steps 1000 --batch-size 8 --fused-stem --ckpt-dir checkpoints/inpaint

The same flags as the JAX CLI. Runs on the first CUDA device when there
is one, else on the CPU (the plain versions of the kernels). Train with
``--freeze-bn`` for the paper's phase-2 fine-tune. VGG16 weights load
from ``--vgg-ckpt`` (a torchvision ``vgg16`` state_dict) or are random,
with a warning. Logs one JSON line per ``--log-every`` window to stdout.
Flags whose machinery is not ported yet raise ``SystemExit``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from text_segmentation_image_inpainting_tpu_torch.data.pipeline import (
    list_image_paths,
    make_dataset,
    to_device,
)
from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
    InpaintLossConfig,
    make_vgg,
)
from text_segmentation_image_inpainting_tpu_torch.models.partial_convolution import InpaintUNet
from text_segmentation_image_inpainting_tpu_torch.models.vgg import (
    VGG16Features,
    load_vgg16_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.train.checkpoint import CheckpointManager
from text_segmentation_image_inpainting_tpu_torch.train.config import (
    InpaintTrainConfig,
    OptimizerConfig,
)
from text_segmentation_image_inpainting_tpu_torch.train.inpaint import (
    make_inpaint_eval_step,
    make_inpaint_train_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state
from text_segmentation_image_inpainting_tpu_torch.train.val import make_val_batches, scored_eval


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--freeze-bn", action="store_true", help="phase-2 fine-tune")
    p.add_argument("--attention", action="store_true",
                   help="not ported yet (ROADMAP Queue 1 item 13): refused")
    p.add_argument("--attention-sn", action="store_true",
                   help="not ported yet (ROADMAP Queue 1 item 13): refused")
    p.add_argument("--pconv-impl", choices=["xla", "pallas"], default="xla",
                   help="accepted for the JAX CLI's sake; the port routes each partial "
                        "conv by device and shape alone (kernels K1/K2 on CUDA)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="only 1: accumulation waits for train/accum.py (ROADMAP Queue 1 item 10)")
    p.add_argument("--remat", choices=["none", "full"], default="none",
                   help="'full' recomputes the U-Net forward in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="only 1: multi-step dispatch waits for train/multistep.py "
                        "(ROADMAP Queue 1 item 10)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false",
                   help="a float32 step: runs on the CPU; on CUDA the partial-conv "
                        "kernels take bf16 only and raise (no fallback)")
    p.add_argument("--fused-stem", action="store_true", default=False,
                   help="the VGG stem's backward on kernel K4 (csrc/vgg_stem.cu)")
    p.add_argument("--vgg-ckpt", type=str, default=None, help="torchvision vgg16 state_dict (.pth)")
    p.add_argument("--ckpt-dir", type=str, default="checkpoints/inpaint")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val-batches", type=int, default=2,
                   help="held-out val batches scored every --log-every window "
                        "(0 = score the train batch)")
    p.add_argument("--export", type=str, default=None,
                   help="not ported yet (ROADMAP Queue 1 item 10): refused")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.attention or args.attention_sn:
        raise SystemExit("--attention/--attention-sn: the attention track is not ported "
                         "(ROADMAP Queue 1 item 13)")
    if args.grad_accum != 1:
        raise SystemExit("--grad-accum > 1: gradient accumulation is not ported "
                         "(ROADMAP Queue 1 item 10, train/accum.py)")
    if args.steps_per_dispatch != 1:
        raise SystemExit("--steps-per-dispatch > 1: multi-step dispatch is not ported "
                         "(ROADMAP Queue 1 item 10, train/multistep.py)")
    if args.export:
        raise SystemExit("--export: the model snapshot is not ported "
                         "(ROADMAP Queue 1 item 10, models/base.py)")


def load_vgg(vgg: VGG16Features, ckpt_path: str | None) -> VGG16Features:
    if not ckpt_path:
        print("WARNING: random VGG16 weights (no --vgg-ckpt given); "
              "perceptual/style terms are untrained-feature losses")
        return vgg
    load_vgg16_state_dict(vgg, torch.load(ckpt_path, map_location="cpu", weights_only=True))
    return vgg


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)
    cfg = InpaintTrainConfig(
        image_size=(args.image_size, args.image_size),
        batch_size=args.batch_size,
        depth=args.depth,
        freeze_bn=args.freeze_bn,
        remat=args.remat,
        bf16_compute=args.bf16,
        # --no-bf16 is a fully f32 step: the VGG trunk follows the flag
        loss=InpaintLossConfig(vgg_dtype="bfloat16" if args.bf16 else "float32",
                               fused_stem=args.fused_stem),
        pconv_impl=args.pconv_impl,
        optimizer=OptimizerConfig(learning_rate=args.lr),
        checkpoint_every=args.ckpt_every,
        log_every=args.log_every,
    )
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    dtype = torch.bfloat16 if cfg.bf16_compute else torch.float32
    gen = torch.Generator().manual_seed(args.seed)
    model = InpaintUNet(depth=cfg.depth, dtype=dtype).init_weights(gen).to(device)
    vgg = load_vgg(make_vgg(cfg.loss), args.vgg_ckpt).to(device)

    paths = list_image_paths(args.data_dir) if args.data_dir else None
    host_it = make_dataset("inpaint", batch_size=cfg.batch_size, size=cfg.image_size,
                           seed=args.seed, paths=paths)

    state = create_train_state(model, cfg.optimizer)
    ckpt = CheckpointManager(args.ckpt_dir, save_interval_steps=cfg.checkpoint_every)
    state, restored_step = ckpt.restore_latest(state)
    if restored_step is not None:
        print(f"resumed from step {restored_step}")
    first_step = state.step

    train_step = make_inpaint_train_step(model, cfg, vgg)
    eval_step = make_inpaint_eval_step(model)
    # a fixed held-out set from a disjoint seed stream
    val_batches = make_val_batches("inpaint", cfg, seed=args.seed + 100_000, n=args.val_batches,
                                   device=device, paths=paths)

    t0 = time.time()
    window_start = first_step
    for step in range(first_step, args.steps):
        batch = to_device(next(host_it), device)
        state, terms = train_step(state, batch)
        done = step + 1
        if step == first_step:
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.time()  # the first step (kernel build, warm-up) is not timed
            window_start = done
        if done % cfg.log_every == 0:
            if device.type == "cuda":
                torch.cuda.synchronize()
            train_elapsed = time.time() - t0
            m = {k: float(v) for k, v in terms.items()}
            m.update(scored_eval(eval_step, state, val_batches) if val_batches
                     else scored_eval(eval_step, state, [batch], prefix=""))
            if done > window_start:
                m["pages_per_sec"] = (done - window_start) * cfg.batch_size / max(train_elapsed, 1e-9)
            print(json.dumps({"step": done, **m}), flush=True)
            t0 = time.time()
            window_start = done
        ckpt.save(done, state)
    ckpt.wait()
    ckpt.close()
    print("done:", state.step, "steps")
    return state


if __name__ == "__main__":
    main()
