"""The inpainting training CLI, the port's counterpart of
``text_segmentation_image_inpainting_tpu/train/run_inpaint.py``.

    python -m text_segmentation_image_inpainting_tpu_torch.train.run_inpaint \\
        --steps 1000 --batch-size 8 --fused-stem --ckpt-dir checkpoints/inpaint

The same flags as the JAX CLI, plus ``--device``: the first CUDA device
(the default; a host without CUDA is an error) or ``cpu`` (the plain
versions of the kernels). Train with ``--freeze-bn`` for the paper's
phase-2 fine-tune. The U-Net and the VGG16 trunk draw their initial
weights, in that order, from one ``torch.Generator`` seeded with
``--seed`` (flax's initialisers, as JAX), so a run depends on its flags
alone. ``--vgg-ckpt`` (a torchvision ``vgg16`` state_dict) then loads
into the trunk tolerantly, as JAX's does: the trunk convs that match in
name and shape, with a one-line report (``compat/torchvision.py``);
without it the trunk stays random, with a warning. ``--attention`` puts
the SAGAN block on the U-Net's bottleneck (``--attention-sn`` also
spectral-normalises it); ``--grad-accum k`` averages k microbatches'
gradients into one update; ``--steps-per-dispatch k`` runs k steps per
dispatch, as a CUDA graph on the card. Logs one record per ``--log-every`` window to
``logs/inpaint.jsonl`` and stderr.

Started by ``torchrun --nproc-per-node N`` (``WORLD_SIZE`` > 1) it trains
data-parallel over the global batch, one rank per device, as the JAX CLI
does over every device (``train/loop.py::run_data_parallel``); no flag.
"""

from __future__ import annotations

import argparse

import torch

from text_segmentation_image_inpainting_tpu_torch.compat.torchvision import (
    load_torch_file,
    tolerant_import,
    vgg16_features_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.data.pipeline import list_image_paths, make_dataset
from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
    InpaintLossConfig,
    make_vgg,
)
from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import flax_init_
from text_segmentation_image_inpainting_tpu_torch.models.partial_convolution import InpaintUNet
from text_segmentation_image_inpainting_tpu_torch.models.vgg import VGG16Features
from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import replicated
from text_segmentation_image_inpainting_tpu_torch.train.config import (
    InpaintTrainConfig,
    OptimizerConfig,
)
from text_segmentation_image_inpainting_tpu_torch.train.inpaint import (
    make_inpaint_eval_step,
    make_inpaint_train_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.loop import (
    add_device_flag,
    check_grad_accum,
    export,
    run_data_parallel,
    steps_per_dispatch,
    train_loop,
)
from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state
from text_segmentation_image_inpainting_tpu_torch.train.val import make_val_batches


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--freeze-bn", action="store_true", help="phase-2 fine-tune")
    p.add_argument("--attention", action="store_true",
                   help="SAGAN self-attention block at the U-Net bottleneck")
    p.add_argument("--attention-sn", action="store_true",
                   help="spectral-normalised attention projections (implies --attention)")
    p.add_argument("--pconv-impl", choices=["xla", "pallas"], default="xla",
                   help="accepted for the JAX CLI's sake; the port routes each partial "
                        "conv by device and shape alone (kernels K1/K2 on CUDA)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each batch into k microbatches, average their gradients, "
                        "apply ONE optimizer update")
    p.add_argument("--remat", choices=["none", "full"], default="none",
                   help="'full' recomputes the U-Net forward in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="run k train steps per dispatch, as a CUDA graph on the card "
                        "(clamped to divide --log-every and --ckpt-every)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false",
                   help="a float32 step: on CUDA the partial convs run the kernels' "
                        "float32 forms (csrc/partial_conv.cu, pconv_f32), and with "
                        "--fused-stem the VGG stem K4F/K5F (csrc/vgg_stem.cu)")
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
                   help="write the final model snapshot here (models/base.py::save_model; "
                        "load_model reads it)")
    add_device_flag(p)
    return p.parse_args(argv)


def load_vgg(vgg: VGG16Features, ckpt_path: str | None,
             generator: torch.Generator) -> VGG16Features:
    """Random weights drawn from ``generator`` with flax's ``nn.Conv``
    initialisers (LeCun-normal kernels, zero biases), as the JAX CLI draws
    its template from its key; then ``ckpt_path``'s trunk, tolerantly, as
    JAX's ``load_vgg_variables``: a conv the file lacks, or holds at
    another shape, keeps its random weights, and the report says so."""
    flax_init_(vgg, 1.0, generator)
    if not ckpt_path:
        print("WARNING: random VGG16 weights (no --vgg-ckpt given); "
              "perceptual/style terms are untrained-feature losses")
        return vgg
    tolerant_import(vgg, vgg16_features_state_dict(load_torch_file(ckpt_path)))
    return vgg


def main(argv=None):
    args = parse_args(argv)
    cfg = InpaintTrainConfig(
        image_size=(args.image_size, args.image_size),
        batch_size=args.batch_size,
        depth=args.depth,
        freeze_bn=args.freeze_bn,
        attention=args.attention or args.attention_sn,
        attention_sn=args.attention_sn,
        grad_accum=args.grad_accum,
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
    check_grad_accum(cfg)
    spd = steps_per_dispatch(args.steps_per_dispatch, cfg)
    device, mesh = run_data_parallel(args.device, cfg.batch_size)
    if device is None:
        return None  # a rank outside the data-parallel mesh: nothing to train
    dtype = torch.bfloat16 if cfg.bf16_compute else torch.float32
    gen = torch.Generator().manual_seed(args.seed)
    model = InpaintUNet(depth=cfg.depth, attention=cfg.attention, attention_sn=cfg.attention_sn,
                        dtype=dtype).init_weights(gen).to(device)
    vgg = load_vgg(make_vgg(cfg.loss), args.vgg_ckpt, gen).to(device)
    if mesh is not None:  # one copy of the weights on every rank, as JAX's replicated(mesh)
        model, vgg = replicated(mesh).place(model), replicated(mesh).place(vgg)

    paths = list_image_paths(args.data_dir) if args.data_dir else None

    def make_batches(start: int):  # the loop picks the start after it has restored the state
        return make_dataset("inpaint", batch_size=cfg.batch_size, size=cfg.image_size,
                            seed=args.seed, paths=paths, start=start)

    # a fixed held-out set from a disjoint seed stream
    val_batches = make_val_batches("inpaint", cfg, mesh, seed=args.seed + 100_000,
                                   n=args.val_batches, device=None if mesh else device,
                                   paths=paths)
    # a step captured in a CUDA graph needs the capturable optimizer
    state = create_train_state(model, cfg.optimizer, capturable=spd > 1 and device.type == "cuda")
    state = train_loop(state, make_inpaint_train_step(model, cfg, vgg, mesh=mesh),
                       make_inpaint_eval_step(model, mesh=mesh), make_batches, val_batches, cfg,
                       steps=args.steps, ckpt_dir=args.ckpt_dir, device=device, name="inpaint",
                       spd=spd, mesh=mesh)
    export(args.export, state.model)
    return state


if __name__ == "__main__":
    main()
