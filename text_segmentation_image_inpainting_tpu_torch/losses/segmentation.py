"""Segmentation losses for the binary text mask.

Counterpart of ``text_segmentation_image_inpainting_tpu/losses/segmentation.py``:
weighted BCE on logits plus dice, optionally focal. Inputs are logits
(N, H, W, 1) and targets in {0, 1} of the same shape; bf16 and f16 are
promoted to f32 (f64 stays f64); every reduction is a mean over the batch.
Under ``ops/collectives.py::data_parallel`` each term is the rank's share
of the global batch's mean (its shard's mean over the number of ranks: the
shards are equal, and the dice is a mean of per-sample terms), so the
ranks' terms add up to the global ones.
"""

from __future__ import annotations

import torch

from text_segmentation_image_inpainting_tpu_torch.ops.collectives import local_share


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _max0(x: torch.Tensor) -> torch.Tensor:
    # torch.maximum splits the gradient of a tie, as jnp.maximum does
    return torch.maximum(x, x.new_zeros(()))


def bce_with_logits(logits, targets, *, pos_weight: float | None = None) -> torch.Tensor:
    """Numerically stable BCE on logits; ``pos_weight`` scales the positive
    term as torch's ``BCEWithLogitsLoss(pos_weight=...)`` does."""
    logits = _at_least_f32(logits)
    targets = targets.to(logits.dtype)
    softplus = torch.log1p(torch.exp(-logits.abs()))
    if pos_weight is None:
        loss = _max0(logits) - logits * targets + softplus
    else:
        log_sig = torch.minimum(logits, logits.new_zeros(())) - softplus  # log(sigmoid(x))
        log_one_minus = -_max0(logits) - softplus  # log(1 - sigmoid(x))
        loss = -(pos_weight * targets * log_sig + (1.0 - targets) * log_one_minus)
    return local_share(loss.mean())


def dice_loss(logits, targets, *, eps: float = 1.0) -> torch.Tensor:
    """Soft dice 1 - (2|P.T| + eps) / (|P| + |T| + eps) per sample, then the mean."""
    probs = torch.sigmoid(_at_least_f32(logits))
    targets = targets.to(probs.dtype)
    axes = tuple(range(1, probs.dim()))
    inter = (probs * targets).sum(axes)
    denom = probs.sum(axes) + targets.sum(axes)
    return local_share((1.0 - (2.0 * inter + eps) / (denom + eps)).mean())


def focal_loss(logits, targets, *, gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Focal loss (Lin et al. 2017) on logits."""
    logits = _at_least_f32(logits)
    targets = targets.to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = _max0(logits) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return local_share((alpha_t * (1.0 - p_t) ** gamma * ce).mean())


def segmentation_loss(logits, targets, *, bce_weight: float = 1.0, dice_weight: float = 1.0,
                      focal_weight: float = 0.0, pos_weight: float | None = None):
    """(total, terms): weighted BCE + dice (+ focal); ``terms`` holds each
    term that has a weight, and ``total``."""
    total = 0.0
    terms = {}
    if bce_weight:
        terms["bce"] = bce_with_logits(logits, targets, pos_weight=pos_weight)
        total += bce_weight * terms["bce"]
    if dice_weight:
        terms["dice"] = dice_loss(logits, targets)
        total += dice_weight * terms["dice"]
    if focal_weight:
        terms["focal"] = focal_loss(logits, targets)
        total += focal_weight * terms["focal"]
    terms["total"] = total
    return total, terms
