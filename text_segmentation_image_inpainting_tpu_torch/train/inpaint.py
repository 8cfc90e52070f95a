"""Inpainting training step.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/inpaint.py``:
forward through the partial-conv U-Net in training mode, the Liu-2018
loss through the frozen VGG16, backward, one optimizer update. On CUDA
the U-Net's stride-1 partial convs run K1/K2 forward and K3 backward,
and with ``cfg.loss.fused_stem`` the VGG stem's backward is K4.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.utils.checkpoint

from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import inpainting_loss
from text_segmentation_image_inpainting_tpu_torch.models.vgg import VGG16Features
from text_segmentation_image_inpainting_tpu_torch.train.config import InpaintTrainConfig
from text_segmentation_image_inpainting_tpu_torch.train.metrics import psnr, ssim
from text_segmentation_image_inpainting_tpu_torch.train.state import TrainState


def make_inpaint_train_step(model, cfg: InpaintTrainConfig, vgg: VGG16Features):
    """Returns ``train_step(state, batch) -> (state, terms)``.

    batch: {'image': (N,H,W,3) ground truth in [0,1],
            'mask':  (N,H,W,1) validity mask, 1 = keep, 0 = hole}.
    The terms are the loss terms, detached.
    """
    if cfg.grad_accum > 1:
        raise NotImplementedError("grad_accum > 1 waits for the port of train/accum.py "
                                  "(ROADMAP Queue 1 item 10)")
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"InpaintTrainConfig.remat must be 'none'|'full', got {cfg.remat!r}")

    def fwd(x, m):
        # cfg.freeze_bn: Liu et al. phase 2, ONLY the encoder BNs frozen
        return model(x, m, freeze_enc_bn=cfg.freeze_bn)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        gt, mask = batch["image"], batch["mask"]
        model.train()
        if cfg.remat == "full":
            # the recompute in backward would move the BN running stats a
            # second time: keep the first forward's and put them back
            out = torch.utils.checkpoint.checkpoint(fwd, gt * mask, mask, use_reentrant=False)
            with torch.no_grad():
                stats = [b.clone() for b in model.buffers()]
        else:
            out = fwd(gt * mask, mask)
        loss, terms = inpainting_loss(out, gt, mask, vgg, config=cfg.loss)
        loss.backward()
        if cfg.remat == "full":
            with torch.no_grad():
                for b, saved in zip(model.buffers(), stats):
                    b.copy_(saved)
        state.apply_gradients()
        return state, {k: v.detach() for k, v in terms.items()}

    return train_step


def make_inpaint_eval_step(model):
    """eval_step(state, batch) -> PSNR / SSIM / L1 of the composited output."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        gt, mask = batch["image"], batch["mask"]
        model.eval()
        out = model(gt * mask, mask)
        comp = mask * gt + (1 - mask) * out.float()
        return {"psnr": psnr(comp, gt), "ssim": ssim(comp, gt), "l1": (comp - gt).abs().mean()}

    return eval_step
