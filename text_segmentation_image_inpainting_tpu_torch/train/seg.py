"""Segmentation training step.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/seg.py``:
forward through the segmenter in training mode (BatchNorm moves its
statistics, with ``freeze_encoder`` too, as in JAX), BCE + dice, backward,
one optimizer update; with ``cfg.grad_accum`` = k > 1 the forward and
backward run on k microbatches and the update takes their mean gradient
(``train/accum.py``). With ``ops/depthwise.py::USE_CUSTOM_WGRAD`` on, the
encoder's stride-1 depthwise convs with C >= 128 take their weight
gradient from K6. Made over a rank mesh (``parallel/mesh.py``), the step
is one rank's part of JAX's global-batch step: BatchNorm and the loss take
the global batch's sums, and the gradients are summed over the ranks
before ``grad_norm`` and the clip (``train/accum.py``).
"""

from __future__ import annotations

from typing import Dict

import torch

from text_segmentation_image_inpainting_tpu_torch.losses.segmentation import segmentation_loss
from text_segmentation_image_inpainting_tpu_torch.ops.collectives import global_sum
from text_segmentation_image_inpainting_tpu_torch.train.accum import accumulate_grads
from text_segmentation_image_inpainting_tpu_torch.train.config import SegTrainConfig
from text_segmentation_image_inpainting_tpu_torch.train.state import TrainState, data_parallel


def make_seg_train_step(model, cfg: SegTrainConfig, *, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {'image': (N,H,W,3) float, 'mask': (N,H,W,1) in {0,1}}; over a
    rank ``mesh``, this rank's rows of the global batch (``shard_batch``).
    metrics: the loss terms and ``grad_norm``, detached (means over the
    microbatches with ``cfg.grad_accum`` > 1; the global batch's over a
    rank mesh, the same on every rank).
    """

    def micro_step(mb: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        logits = model(mb["image"])
        loss, terms = segmentation_loss(
            logits, mb["mask"], bce_weight=cfg.bce_weight, dice_weight=cfg.dice_weight,
            focal_weight=cfg.focal_weight, pos_weight=cfg.pos_weight,
        )
        loss.backward()
        return {k: v.detach() for k, v in terms.items()}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model.train()
        with data_parallel(mesh):
            metrics = accumulate_grads(micro_step, batch, cfg.grad_accum, state.clip_params)
        # before apply_gradients, which clips in place: JAX takes the norm of
        # the (mean) raw gradients of every parameter, frozen ones included
        grads = [p.grad for p in state.clip_params if p.grad is not None]
        metrics["grad_norm"] = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
        state.apply_gradients()
        return state, metrics

    train_step.mesh = mesh
    return train_step


def make_seg_eval_step(model, *, threshold: float = 0.5, mesh=None):
    """eval_step(state, batch) -> IoU, precision and recall of the batch
    (over a rank ``mesh``, of the global batch: its counts summed over the
    ranks).

    It thresholds ``sigmoid`` of the f32 logits, as JAX's eval step does
    (the page pipeline thresholds in logit space instead; the two are
    kept apart on purpose)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model.eval()
        logits = model(batch["image"])
        pred = (torch.sigmoid(logits.float()) > threshold).float()
        gt = batch["mask"].float()
        with data_parallel(mesh):
            tp, fp, fn = global_sum(torch.stack(
                [(pred * gt).sum(), (pred * (1 - gt)).sum(), ((1 - pred) * gt).sum()]))
        eps = 1e-6
        return {
            "iou": tp / (tp + fp + fn + eps),
            "precision": tp / (tp + fp + eps),
            "recall": tp / (tp + fn + eps),
        }

    return eval_step
