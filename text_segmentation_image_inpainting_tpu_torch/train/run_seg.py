"""The segmentation training CLI, the port's counterpart of
``text_segmentation_image_inpainting_tpu/train/run_seg.py``.

    python -m text_segmentation_image_inpainting_tpu_torch.train.run_seg \\
        --steps 1000 --batch-size 8 --ckpt-dir checkpoints/seg

The same flags as the JAX CLI, plus ``--device``: the first CUDA device
(the default; a host without CUDA is an error) or ``cpu``. ``--custom-wgrad`` sets
``ops/depthwise.py::USE_CUSTOM_WGRAD``, so the encoder's depthwise weight
gradients run on kernel K6 (off by default, as in JAX). Train with
``--freeze-encoder`` for the staged fine-tune. ``--backbone xception``
and ``--head deeplab`` select the experiment tracks (the Xception encoder
with its 8 middle blocks, the DeepLab-v3+ head); ``--grad-accum k``
averages k microbatches' gradients into one update; ``--steps-per-dispatch
k`` runs k steps per dispatch, as a CUDA graph on the card. Logs one
record per ``--log-every`` window to ``logs/seg.jsonl`` and stderr.

Started by ``torchrun --nproc-per-node N`` (``WORLD_SIZE`` > 1) it trains
data-parallel over the global batch, one rank per device, as the JAX CLI
does over every device (``train/loop.py::run_data_parallel``); no flag.
"""

from __future__ import annotations

import argparse

import torch

from text_segmentation_image_inpainting_tpu_torch.data.pipeline import list_image_paths, make_dataset
from text_segmentation_image_inpainting_tpu_torch.models import TextSegmenter
from text_segmentation_image_inpainting_tpu_torch.ops import depthwise
from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import replicated
from text_segmentation_image_inpainting_tpu_torch.train.config import (
    OptimizerConfig,
    SegTrainConfig,
)
from text_segmentation_image_inpainting_tpu_torch.train.seg import (
    make_seg_eval_step,
    make_seg_train_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.loop import (
    add_device_flag,
    check_grad_accum,
    export,
    run_data_parallel,
    steps_per_dispatch,
    train_loop,
)
from text_segmentation_image_inpainting_tpu_torch.train.state import (
    create_train_state,
    freeze_mask_for,
)
from text_segmentation_image_inpainting_tpu_torch.train.val import make_val_batches


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--width-mult", type=float, default=1.0)
    p.add_argument("--backbone", choices=("mobilenet_v2", "xception"), default="mobilenet_v2")
    p.add_argument("--head", choices=("mini", "deeplab"), default="mini")
    p.add_argument("--output-stride", type=int, default=8, choices=(8, 16, 32))
    p.add_argument("--decoder-mid", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--pos-weight", type=float, default=3.0)
    p.add_argument("--freeze-encoder", action="store_true")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each batch into k microbatches, average their gradients, "
                        "apply ONE optimizer update")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="run k train steps per dispatch, as a CUDA graph on the card "
                        "(clamped to divide --log-every and --ckpt-every)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--custom-wgrad", action="store_true", default=False,
                   help="depthwise weight gradients on kernel K6 (csrc/depthwise_wgrad.cu)")
    p.add_argument("--ckpt-dir", type=str, default="checkpoints/seg")
    p.add_argument("--data-dir", type=str, default=None, help="image folder; synthetic if unset")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val-batches", type=int, default=2,
                   help="held-out val batches scored every --log-every window "
                        "(0 = score the train batch)")
    p.add_argument("--export", type=str, default=None,
                   help="write the final model snapshot here (models/base.py::save_model; "
                        "load_model reads it)")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = SegTrainConfig(
        image_size=(args.image_size, args.image_size),
        batch_size=args.batch_size,
        width_mult=args.width_mult,
        backbone=args.backbone,
        head=args.head,
        output_stride=args.output_stride,
        decoder_mid=args.decoder_mid,
        pos_weight=args.pos_weight,
        freeze_encoder=args.freeze_encoder,
        grad_accum=args.grad_accum,
        bf16_compute=args.bf16,
        optimizer=OptimizerConfig(learning_rate=args.lr),
        checkpoint_every=args.ckpt_every,
        log_every=args.log_every,
    )
    check_grad_accum(cfg)
    spd = steps_per_dispatch(args.steps_per_dispatch, cfg)
    if args.custom_wgrad:
        depthwise.USE_CUSTOM_WGRAD = True  # read at every forward (ops/depthwise.py)
    device, mesh = run_data_parallel(args.device, cfg.batch_size)
    if device is None:
        return None  # a rank outside the data-parallel mesh: nothing to train
    dtype = torch.bfloat16 if cfg.bf16_compute else torch.float32
    model = TextSegmenter(width_mult=cfg.width_mult, output_stride=cfg.output_stride,
                          decoder_mid=cfg.decoder_mid, backbone=cfg.backbone, head=cfg.head,
                          dtype=dtype)
    model = model.init_weights(torch.Generator().manual_seed(args.seed)).to(device)
    if mesh is not None:  # one copy of the weights on every rank, as JAX's replicated(mesh)
        model = replicated(mesh).place(model)

    paths = list_image_paths(args.data_dir) if args.data_dir else None

    def make_batches(start: int):  # the loop picks the start after it has restored the state
        return make_dataset("seg", batch_size=cfg.batch_size, size=cfg.image_size,
                            seed=args.seed, paths=paths, start=start)

    frozen = freeze_mask_for(model, "encoder") if cfg.freeze_encoder else frozenset()
    # a fixed held-out set from a disjoint seed stream
    val_batches = make_val_batches("seg", cfg, mesh, seed=args.seed + 100_000,
                                   n=args.val_batches, device=None if mesh else device,
                                   paths=paths)
    # a step captured in a CUDA graph needs the capturable optimizer
    state = create_train_state(model, cfg.optimizer, frozen=frozen,
                               capturable=spd > 1 and device.type == "cuda")
    state = train_loop(state, make_seg_train_step(model, cfg, mesh=mesh),
                       make_seg_eval_step(model, mesh=mesh), make_batches, val_batches, cfg,
                       steps=args.steps, ckpt_dir=args.ckpt_dir, device=device, name="seg",
                       spd=spd, mesh=mesh)
    export(args.export, state.model)
    return state


if __name__ == "__main__":
    main()
