"""Inpainting training step.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/inpaint.py``:
forward through the partial-conv U-Net in training mode, the Liu-2018
loss through the frozen VGG16, backward, one optimizer update. On CUDA
the U-Net's stride-1 partial convs run K1/K2 forward and K3 backward,
and with ``cfg.loss.fused_stem`` the VGG stem's backward is K4. With
``cfg.grad_accum`` = k > 1 the forward and backward run on k microbatches
and the update takes their mean gradient (``train/accum.py``). Made over
a rank mesh (``parallel/mesh.py``), the step is one rank's part of JAX's
global-batch step: BatchNorm and the loss take the global batch's sums,
and the gradients are summed over the ranks.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.utils.checkpoint

from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import inpainting_loss
from text_segmentation_image_inpainting_tpu_torch.models.vgg import VGG16Features
from text_segmentation_image_inpainting_tpu_torch.ops.collectives import global_sum, local_share
from text_segmentation_image_inpainting_tpu_torch.train.accum import accumulate_grads
from text_segmentation_image_inpainting_tpu_torch.train.config import InpaintTrainConfig
from text_segmentation_image_inpainting_tpu_torch.train.metrics import psnr, ssim
from text_segmentation_image_inpainting_tpu_torch.train.state import TrainState, data_parallel
from text_segmentation_image_inpainting_tpu_torch.utils.profiling import span


def make_inpaint_train_step(model, cfg: InpaintTrainConfig, vgg: VGG16Features, *, mesh=None):
    """Returns ``train_step(state, batch) -> (state, terms)``.

    batch: {'image': (N,H,W,3) ground truth in [0,1],
            'mask':  (N,H,W,1) validity mask, 1 = keep, 0 = hole}; over a
    rank ``mesh``, this rank's rows of the global batch (``shard_batch``).
    The terms are the loss terms, detached (microbatch means with
    ``cfg.grad_accum`` > 1; the global batch's over a rank mesh).
    """
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"InpaintTrainConfig.remat must be 'none'|'full', got {cfg.remat!r}")

    def fwd(x, m):
        # cfg.freeze_bn: Liu et al. phase 2, ONLY the encoder BNs frozen
        return model(x, m, freeze_enc_bn=cfg.freeze_bn)

    def micro_step(mb: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        gt, mask = mb["image"], mb["mask"]
        with span("train.forward"):
            if cfg.remat == "full":
                # the recompute in backward would move the BN running stats a
                # second time: keep the first forward's and put them back
                out = torch.utils.checkpoint.checkpoint(fwd, gt * mask, mask,
                                                        use_reentrant=False)
                with torch.no_grad():
                    stats = [b.clone() for b in model.buffers()]
            else:
                out = fwd(gt * mask, mask)
        with span("train.loss"):
            loss, terms = inpainting_loss(out, gt, mask, vgg, config=cfg.loss)
        with span("train.backward"):
            loss.backward()
        if cfg.remat == "full":
            with torch.no_grad():
                for b, saved in zip(model.buffers(), stats):
                    b.copy_(saved)
        return {k: v.detach() for k, v in terms.items()}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model.train()
        with data_parallel(mesh):
            terms = accumulate_grads(micro_step, batch, cfg.grad_accum, state.clip_params)
        with span("train.update"):
            state.apply_gradients()
        return state, terms

    train_step.mesh = mesh
    return train_step


def make_inpaint_eval_step(model, *, mesh=None):
    """eval_step(state, batch) -> PSNR / SSIM / L1 of the composited output
    (over a rank ``mesh``, of the global batch)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        gt, mask = batch["image"], batch["mask"]
        model.eval()
        out = model(gt * mask, mask)
        comp = mask * gt + (1 - mask) * out.float()
        with data_parallel(mesh):
            return {"psnr": psnr(comp, gt), "ssim": ssim(comp, gt),
                    "l1": global_sum(local_share((comp - gt).abs().mean()))}

    return eval_step
