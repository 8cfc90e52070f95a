"""Partial-convolution layer + inpainting U-Net (Liu et al. 2018).

Counterpart of ``text_segmentation_image_inpainting_tpu/models/partial_convolution.py``
in its literal composition (``InpaintUNet(fuse_up=False)``): every
decoder level upsamples features and mask (nearest x2), concatenates the
skip, and runs a 3x3 partial conv over G=2 mask groups (C_lo, C_skip).
Routing to the fused kernels is ``ops.partial_conv.partial_conv2d``'s
alone: the stride-1 decoder levels and the head reach K1/K2, the
stride-2 encoder the plain cuDNN formulation.

State_dict names follow the torch oracle: ``enc_convs.{i}.conv``,
``enc_bns.{i}``, ``dec_convs.{j}.conv`` (j = 0 is the deepest level),
``dec_bns.{j}``, ``head.conv``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import BatchNorm
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import partial_conv2d
from text_segmentation_image_inpainting_tpu_torch.ops.resize import upsample_nearest


class PartialConv(nn.Module):
    """Partial 2-D convolution: (features, mask) -> (features', mask'), NHWC."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 padding: int | None = None, dilation: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        pad = dilation * (kernel_size - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, pad, dilation=dilation, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, mask: torch.Tensor, *,
                group_sizes: Sequence[int] | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        c = self.conv
        return partial_conv2d(
            x, mask.to(self.dtype), c.weight.to(self.dtype),
            None if c.bias is None else c.bias.to(self.dtype),
            group_sizes=group_sizes, stride=c.stride, padding=c.padding, dilation=c.dilation,
        )


class InpaintUNet(nn.Module):
    """Partial-conv U-Net inpainting generator.

    Encoder: stride-2 partial convs (kernels 7/5/5/3..., channels
    64->512), ReLU, BatchNorm except the first layer. Decoder: nearest x2
    upsample of features and mask, concat skip features and skip mask,
    3x3 partial conv, BatchNorm, LeakyReLU(0.2). The head concatenates
    the raw (image, mask) input and maps to RGB with bias.

    ``depth`` (default 8) fits 512x512 inputs; the spatial size must be
    divisible by ``2**depth``.
    """

    ENC: Tuple[Tuple[int, int, bool], ...] = (
        (64, 7, False),
        (128, 5, True),
        (256, 5, True),
        (512, 3, True),
        (512, 3, True),
        (512, 3, True),
        (512, 3, True),
        (512, 3, True),
    )

    def __init__(self, depth: int = 8, cin: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        if not 3 <= depth <= 8:
            raise ValueError(f"depth must be 3..8, got {depth}")
        self.depth = depth
        self.dtype = dtype
        self.enc_convs = nn.ModuleList()
        self.enc_bns = nn.ModuleList()
        chans = []
        c = cin
        for cout, k, use_bn in self.ENC[:depth]:
            self.enc_convs.append(PartialConv(c, cout, k, stride=2, bias=not use_bn, dtype=dtype))
            self.enc_bns.append(BatchNorm(cout) if use_bn else nn.Identity())
            chans.append(cout)
            c = cout
        self.dec_convs = nn.ModuleList()
        self.dec_bns = nn.ModuleList()
        for lvl in range(depth - 1, 0, -1):
            skip_c = chans[lvl - 1]
            self.dec_convs.append(PartialConv(c + skip_c, skip_c, 3, bias=False, dtype=dtype))
            self.dec_bns.append(BatchNorm(skip_c))
            c = skip_c
        self.head = PartialConv(c + cin, 3, 3, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, *,
                freeze_enc_bn: bool = False) -> torch.Tensor:
        """x (N,H,W,3) with holes zeroed, mask (N,H,W,1) with 1 = valid -> (N,H,W,3).

        In training mode ``freeze_enc_bn=True`` runs the *encoder*
        BatchNorms on their running averages while the decoder's keep
        training: the Liu et al. phase-2 fine-tune.
        """
        size = 1 << self.depth
        if x.shape[1] % size or x.shape[2] % size:
            raise ValueError(
                f"spatial dims {tuple(x.shape[1:3])} must be divisible by 2**depth={size}"
            )
        skips = [(x, mask)]
        f, m = x, mask
        for conv, bn in zip(self.enc_convs, self.enc_bns):
            f, m = conv(f, m)
            if isinstance(bn, BatchNorm):
                f = bn(f, frozen=freeze_enc_bn)
            f = F.relu(f)
            skips.append((f, m))
        for j, (conv, bn) in enumerate(zip(self.dec_convs, self.dec_bns)):
            f, m = self._up_cat_conv(conv, f, m, *skips[self.depth - 1 - j])
            f = F.leaky_relu(bn(f), 0.2)
        out, _ = self._up_cat_conv(self.head, f, m, *skips[0])
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> "InpaintUNet":
        """flax's initialisers, as the JAX model's ``init``: every kernel
        He-normal (a normal truncated at 2 sigma, sigma scaled so the
        variance is 2 / fan_in), biases 0, BatchNorm the identity."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                std = (2.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
        return self

    @staticmethod
    def _up_cat_conv(conv, f, m, sf, sm):
        f = upsample_nearest(f, 2)
        m = upsample_nearest(m, 2)
        cat_f = torch.cat([f, sf.to(f.dtype)], dim=-1)
        cat_m = torch.cat([m, sm.to(m.dtype)], dim=-1)
        return conv(cat_f, cat_m, group_sizes=(f.shape[-1], sf.shape[-1]))

    @staticmethod
    def compose(out, gt, mask):
        """I_comp = M*I_gt + (1-M)*I_out (the paper's composed image)."""
        return mask * gt + (1.0 - mask) * out
