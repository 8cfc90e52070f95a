"""Quality metrics: IoU, PSNR, SSIM.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/metrics.py``.
Every metric computes in f32 and returns a 0-d tensor. Under
``ops/collectives.py::data_parallel`` each is the global batch's: sums
and means over the ranks' equal shards.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.collectives import global_sum, local_share
from text_segmentation_image_inpainting_tpu_torch.ops.conv import to_nchw


def iou(pred: torch.Tensor, target: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Binary IoU over the whole batch; inputs in {0,1}."""
    pred, target = pred.float(), target.float()
    inter = global_sum((pred * target).sum())
    union = global_sum(pred.sum() + target.sum()) - inter
    return inter / (union + eps)


def psnr(pred: torch.Tensor, target: torch.Tensor, *, max_val: float = 1.0) -> torch.Tensor:
    mse = global_sum(local_share((pred.float() - target.float()).square().mean()))
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, *, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM (Wang et al. 2004), 11x11 gaussian window, per channel.

    The filter runs in true f32, TF32 off: the sigma terms are
    catastrophic cancellations (E[x^2] - mu^2 ~ 1e-4 on flat page regions
    against c2 = 9e-4), and TF32's 10-bit mantissa there inflates SSIM past
    1 (JAX needs ``Precision.HIGHEST`` on the TPU for the same reason).
    """
    pred, target = pred.float(), target.float()
    c = pred.shape[-1]
    win = _gaussian_kernel(kernel_size, sigma).to(pred.device)
    kernel = win.expand(c, 1, kernel_size, kernel_size)

    def filt(x):
        return F.conv2d(to_nchw(x), kernel, groups=c)

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        mu_p, mu_t = filt(pred), filt(target)
        sig_pp, sig_tt, sig_pt = filt(pred * pred), filt(target * target), filt(pred * target)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    # variances are nonnegative by definition; clamp the cancellation
    sigma_p = torch.clamp(sig_pp - mu_pp, min=0.0)
    sigma_t = torch.clamp(sig_tt - mu_tt, min=0.0)
    sigma_pt = sig_pt - mu_pt
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    num = (2 * mu_pt + c1) * (2 * sigma_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2)
    return global_sum(local_share((num / den).mean()))
