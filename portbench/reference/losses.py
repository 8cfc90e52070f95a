"""Plain f32 losses and Adam of the benchmark's two trainers.

Inpainting (Liu et al. 2018, arXiv:1804.07723 section 4), on NCHW:

    L = w_valid L_valid + w_hole L_hole + w_perc L_perc
        + w_style (L_style_out + L_style_comp) + w_tv L_tv

L_valid = sum |out - gt| M / (sum M * C), L_hole the same over 1 - M;
I_comp = M gt + (1 - M) out; L_perc sums, over the VGG16 pool taps,
sum |f(out) - f(gt)| / numel + sum |f(comp) - f(gt)| / numel; the style
terms are mean |G(f(.)) - G(f(gt))| with G = F^T F / (C H W) per image;
L_tv is the anisotropic total variation of I_comp over pairs that both
lie in the hole dilated by one pixel (3 x 3), over (its area * C).

Segmentation: BCE on logits with the positive term weighted by
``pos_weight`` (mean over pixels) plus soft dice
1 - (2 sum p t + 1) / (sum p + sum t + 1) per image, averaged.

Adam (Kingma & Ba; torch's form): m = b1 m + (1 - b1) g,
v = b2 v + (1 - b2) g^2, p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision


def gram(prec: Precision, f: torch.Tensor) -> torch.Tensor:
    n, c, h, w = f.shape
    flat = f.reshape(n, c, h * w)
    g = torch.bmm(prec.operand(flat), prec.operand(flat).transpose(1, 2))
    prec.record("gram", n * c * c * h * w, f.requires_grad, False, x=tuple(f.shape))
    return prec.store(g) / float(c * h * w)


def inpaint_loss(prec: Precision, vgg, out, gt, mask, w: dict):
    """(total, terms) of the inpainting loss; ``mask`` (N, 1, H, W), 1 = valid."""
    hole = 1.0 - mask
    comp = mask * gt + hole * out
    c = out.shape[1]
    terms = {
        "valid": ((out - gt).abs() * mask).sum() / (torch.clamp(mask.sum(), min=1.0) * c),
        "hole": ((out - gt).abs() * hole).sum() / (torch.clamp(hole.sum(), min=1.0) * c),
    }
    n = out.shape[0]
    feats = vgg(torch.cat([out, comp], 0))
    with torch.no_grad():
        feats_gt = vgg(gt)
    perc = style_out = style_comp = 0.0
    for f, fg in zip(feats, feats_gt):
        fo, fc = f[:n], f[n:]
        perc = perc + (fo - fg).abs().sum() / fg.numel() + (fc - fg).abs().sum() / fg.numel()
        g_gt = gram(prec, fg)
        style_out = style_out + (gram(prec, fo) - g_gt).abs().mean()
        style_comp = style_comp + (gram(prec, fc) - g_gt).abs().mean()
    terms.update(perceptual=perc, style_out=style_out, style_comp=style_comp)
    region = F.max_pool2d(hole, 3, stride=1, padding=1)
    dy = (comp[:, :, 1:] - comp[:, :, :-1]).abs() * (region[:, :, 1:] * region[:, :, :-1])
    dx = (comp[:, :, :, 1:] - comp[:, :, :, :-1]).abs() * (region[:, :, :, 1:]
                                                           * region[:, :, :, :-1])
    terms["tv"] = (dy.sum() + dx.sum()) / (torch.clamp(region.sum(), min=1.0) * c)
    total = (w["valid"] * terms["valid"] + w["hole"] * terms["hole"]
             + w["perceptual"] * terms["perceptual"]
             + w["style"] * (terms["style_out"] + terms["style_comp"]) + w["tv"] * terms["tv"])
    return total, terms


def seg_loss(logits, target, w: dict):
    """(total, terms): weighted BCE on logits + soft dice."""
    sp = F.softplus(-logits.abs())
    log_p = torch.clamp(logits, max=0.0) - sp          # log sigmoid(x)
    log_q = -torch.clamp(logits, min=0.0) - sp         # log (1 - sigmoid(x))
    bce = -(w["pos_weight"] * target * log_p + (1.0 - target) * log_q).mean()
    p = torch.sigmoid(logits)
    axes = tuple(range(1, p.dim()))
    inter = (p * target).sum(axes)
    dice = (1.0 - (2.0 * inter + 1.0) / (p.sum(axes) + target.sum(axes) + 1.0)).mean()
    terms = {"bce": bce, "dice": dice}
    return w["bce"] * bce + w["dice"] * dice, terms


class Adam:
    def __init__(self, params, cfg: dict):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = (cfg["learning_rate"], cfg["beta1"], cfg["beta2"],
                                               cfg["eps"])
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
            p.grad = None
