"""Inpainting loss suite (Liu et al. 2018, section 4).

Counterpart of ``text_segmentation_image_inpainting_tpu/losses/inpainting.py``::

    L_total = w_valid*L_valid + w_hole*L_hole + w_perc*L_perc
            + w_style*(L_style_out + L_style_comp) + w_tv*L_tv

with the paper's weights (1, 6, 0.05, 120, 0.1). ``I_comp`` is
``M*I_gt + (1-M)*I_out``; the perceptual and style terms run ``I_out`` and
``I_comp`` through the frozen VGG16 pool1-3 features in ONE batched
forward (whose stem backward is kernel K4 with ``fused_stem``), and
``I_gt`` through a separate forward without grad (whose stem is kernel
K5 with ``fused_stem``); style uses
Gram matrices; TV runs over the 1-px dilation of the hole. Every sum
accumulates in f32 (f64 stays f64), whatever the VGG dtype.

Under ``ops/collectives.py::data_parallel`` each term is the rank's share
of the global batch's term, so the ranks' terms add up to it: the masked
L1 and TV terms are ratios of global sums (their mask denominators are
summed over the ranks), the others means over equal shards (the rank's
mean over the number of ranks).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from text_segmentation_image_inpainting_tpu_torch.models.vgg import (
    VGG16Features,
    apply_vgg_features,
)
from text_segmentation_image_inpainting_tpu_torch.ops.collectives import global_sum, local_share
from text_segmentation_image_inpainting_tpu_torch.ops.morphology import dilate_mask


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Promote bf16/f16 to f32, keep f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


@dataclasses.dataclass(frozen=True)
class InpaintLossConfig:
    valid: float = 1.0
    hole: float = 6.0
    perceptual: float = 0.05
    style: float = 120.0
    tv: float = 0.1
    vgg_taps: int = 3
    vgg_normalize: bool = True
    # VGG trunk compute dtype ('bfloat16' in training); the loss terms
    # still accumulate in f32
    vgg_dtype: str = "float32"
    # the stem's backward on kernel K4 (VGG is frozen here)
    fused_stem: bool = False


def gram_matrix(feats: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C, C) Gram, divided by C*H*W (the paper's K_p).

    The products are taken and RETURNED in f32 (f64 for f64 input), as
    JAX's ``preferred_element_type``: a bf16 ``torch.bmm`` would round the
    result to bf16. bf16 values are exact in f32, so upcasting first loses
    nothing."""
    n, h, w, c = feats.shape
    f = _at_least_f32(feats).reshape(n, h * w, c)
    return torch.bmm(f.transpose(1, 2), f) / float(c * h * w)


def total_variation_loss(comp: torch.Tensor, hole_region: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV of ``comp`` restricted to ``hole_region`` (N,H,W,1):
    a difference counts when both its endpoints are in the region."""
    comp = _at_least_f32(comp)
    region = hole_region.to(comp.dtype)
    dy = (comp[:, 1:] - comp[:, :-1]).abs() * (region[:, 1:] * region[:, :-1])
    dx = (comp[:, :, 1:] - comp[:, :, :-1]).abs() * (region[:, :, 1:] * region[:, :, :-1])
    denom = torch.clamp(global_sum(region.sum()), min=1.0) * comp.shape[-1]
    return (dy.sum() + dx.sum()) / denom


def _masked_l1(a, b, m, *, normalize_by_mask: bool) -> torch.Tensor:
    diff = (_at_least_f32(a) - _at_least_f32(b)).abs() * m
    if normalize_by_mask:
        return diff.sum() / (torch.clamp(global_sum(m.sum()), min=1.0) * a.shape[-1])
    return local_share(diff.mean())


def make_vgg(config: InpaintLossConfig) -> VGG16Features:
    """The frozen trunk ``config`` asks for (random weights until loaded)."""
    return VGG16Features(num_taps=config.vgg_taps, normalize=config.vgg_normalize,
                         dtype=getattr(torch, config.vgg_dtype))


def inpainting_loss(
    out: torch.Tensor,
    gt: torch.Tensor,
    mask: torch.Tensor,
    vgg: VGG16Features,
    *,
    config: InpaintLossConfig = InpaintLossConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The paper's loss.

    Args:
      out: (N,H,W,3) network output.
      gt: (N,H,W,3) ground truth.
      mask: (N,H,W,1), 1 = valid, 0 = hole.
      vgg: the frozen ``VGG16Features`` (``make_vgg(config)``, loaded);
        ``config`` supplies the term weights and ``fused_stem``.
    """
    mask = mask.to(torch.promote_types(torch.promote_types(out.dtype, mask.dtype), torch.float32))
    hole = 1.0 - mask
    comp = mask * gt + hole * out

    terms: Dict[str, torch.Tensor] = {}
    terms["valid"] = _masked_l1(out, gt, mask, normalize_by_mask=True)
    terms["hole"] = _masked_l1(out, gt, hole, normalize_by_mask=True)

    n = out.shape[0]
    feats_oc = apply_vgg_features(vgg, torch.cat([out, comp], dim=0),
                                  fused_stem=config.fused_stem)
    with torch.no_grad():  # with fused_stem, the stem forward runs K5 here
        feats_gt = apply_vgg_features(vgg, gt, fused_stem=config.fused_stem)

    perc = style_out = style_comp = 0.0
    for f_oc, fg in zip(feats_oc, feats_gt):
        fo, fc = f_oc[:n], f_oc[n:]
        denom = float(fg.numel())
        # abs-diffs in the tap dtype, sums in f32
        acc = torch.promote_types(fo.dtype, torch.float32)
        perc = perc + (fo - fg).abs().sum(dtype=acc) / denom
        perc = perc + (fc - fg).abs().sum(dtype=acc) / denom
        g_gt = gram_matrix(fg)
        style_out = style_out + (gram_matrix(fo) - g_gt).abs().mean()
        style_comp = style_comp + (gram_matrix(fc) - g_gt).abs().mean()
    terms["perceptual"] = local_share(perc)
    terms["style_out"] = local_share(style_out)
    terms["style_comp"] = local_share(style_comp)

    terms["tv"] = total_variation_loss(comp, dilate_mask(hole, radius=1))

    total = (
        config.valid * terms["valid"]
        + config.hole * terms["hole"]
        + config.perceptual * terms["perceptual"]
        + config.style * (terms["style_out"] + terms["style_comp"])
        + config.tv * terms["tv"]
    )
    terms["total"] = total
    return total, terms
