"""The reference's two entry points: a served batch and three training steps.

``Pipeline`` is the page cleaner in plain f32: pages / 255, the
segmenter's logits, text where the logit is above logit(threshold),
dilated by a (2r + 1)^2 max, the U-Net over the valid pixels, and the
composite valid * page + (1 - valid) * out, as uint8 round(clip(., 0, 1) *
255). ``train_steps`` runs the trainer of a configuration for a few steps
from given weights and batches and reports what the benchmark compares.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import losses, nets
from portbench.reference.precision import Precision


def build(cfg: dict, part: str, prec: Precision) -> nn.Module:
    """The reference module of a configuration's part: 'pipeline' (seg +
    unet), 'segmenter', 'unet' or 'vgg'."""
    if part == "pipeline":
        m = nn.Module()
        m.seg = nets.Segmenter(cfg["segmenter"])
        m.unet = nets.UNet(cfg["inpainter"])
    elif part == "segmenter":
        m = nets.Segmenter(cfg["segmenter"])
    elif part == "unet":
        m = nets.UNet(cfg["inpainter"])
    elif part == "vgg":
        m = nets.VGG(cfg["loss"]["vgg_layers"], cfg["loss"]["vgg_taps"])
    else:
        raise ValueError(f"no reference part {part!r}")
    return nets.use_precision(m, prec)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) in [0, 1] -> (N, H, W, C) uint8, half to even."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.uint8).permute(0, 2, 3, 1)


class Pipeline:
    def __init__(self, model: nn.Module, cfg: dict, prec: Precision):
        self.model, self.prec = model.eval(), prec
        self.threshold = cfg["pipeline"]["threshold"]
        self.radius = cfg["pipeline"]["dilate_radius"]

    def page(self, pages_u8: torch.Tensor) -> torch.Tensor:
        return self.prec.value(nchw(pages_u8).float() / 255.0)

    @property
    def logit_threshold(self) -> float:
        return math.log(self.threshold / (1.0 - self.threshold))

    @torch.no_grad()
    def scores(self, pages_u8: torch.Tensor):
        """(each pixel's largest logit over its dilation window (N, H, W, 1),
        the logits' standard deviation over the batch): a pixel is served
        as text where its score is above the logit threshold, since the
        max over a window commutes with the threshold."""
        logits = self.model.seg(self.page(pages_u8))
        k = 2 * self.radius + 1
        pooled = F.max_pool2d(logits, k, stride=1, padding=self.radius)
        return pooled.permute(0, 2, 3, 1), float(logits.std())

    def text(self, pages_u8: torch.Tensor) -> torch.Tensor:
        """The dilated text mask (N, H, W, 1) uint8."""
        return (self.scores(pages_u8)[0] > self.logit_threshold).to(torch.uint8)

    @torch.no_grad()
    def clean(self, pages_u8: torch.Tensor, text_u8: torch.Tensor) -> torch.Tensor:
        """The cleaned pages (N, H, W, 3) uint8 over the given text mask."""
        x = self.page(pages_u8)
        valid = 1.0 - nchw(text_u8).float()
        out = self.model.unet(x * valid, valid)
        return to_u8(valid * x + (1.0 - valid) * out)

    def run(self, pages_u8: torch.Tensor):
        """(clean, text) as the page cleaner serves them."""
        text = self.text(pages_u8)
        return self.clean(pages_u8, text), text


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def stats_change(now: dict, start: dict) -> dict:
    """The norm of each BatchNorm running statistic's change from ``start``."""
    return leaf_norms({k: now[k] - v for k, v in start.items()
                       if k.endswith(("running_mean", "running_var"))})


def train_steps(cfg: dict, kind: str, weights: dict, batches: list, prec: Precision,
                device, dtype: torch.dtype = torch.float32) -> dict:
    """Run the trainer ``kind`` ('inpaint' or 'seg') for len(batches) steps
    from ``weights`` (the trained model's state dict, and the VGG trunk's
    under 'vgg.' for inpainting). Returns the total loss of each step, the
    norm of each leaf's first gradient, of each BatchNorm statistic's change
    in the first step, and of each leaf's change (parameters and BatchNorm
    statistics) over all the steps. ``dtype``
    float64 holds the program to it exactly in tests."""
    part = "unet" if kind == "inpaint" else "segmenter"
    model = build(cfg, part, prec).to(device, dtype)
    model.load_state_dict({k: v for k, v in weights.items() if not k.startswith("vgg.")})
    model.train()
    start = {k: v.detach().clone() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    vgg = None
    if kind == "inpaint":
        vgg = build(cfg, "vgg", prec).to(device, dtype)
        vgg.load_state_dict({k[4:]: v for k, v in weights.items() if k.startswith("vgg.")})
    named = list(model.named_parameters())
    opt = losses.Adam([p for _, p in named], cfg["optimizer"])
    out = {"loss": [], "grad": None}
    for i, b in enumerate(batches):
        img, mask = nchw(b["image"].to(dtype)), nchw(b["mask"].to(dtype))
        if kind == "inpaint":
            pred = model(img * mask, mask)
            loss, _ = losses.inpaint_loss(prec, vgg, pred, img, mask, cfg["loss"])
        else:
            loss, _ = losses.seg_loss(model(img), mask, cfg["seg_loss"])
        loss.backward()
        out["loss"].append(float(loss.detach()))
        if i == 0:
            out["grad"] = leaf_norms({n: p.grad for n, p in named})
            out["stats1"] = stats_change(model.state_dict(), start)
        opt.step()
    now = model.state_dict()
    out["change"] = leaf_norms({k: now[k] - v for k, v in start.items()})
    return out
