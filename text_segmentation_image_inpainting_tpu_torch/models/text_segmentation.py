"""Text-segmentation model: MobileNetV2 encoder + dilated-conv decoder.

Counterpart of ``text_segmentation_image_inpainting_tpu/models/text_segmentation.py``
for ``backbone='mobilenet_v2'`` and ``head='mini'``. Pages are NHWC,
logits (N, H, W, 1). State_dict names follow the torch oracle
(``encoder.*``, ``decoder.aspp.{i}``, ``decoder.head``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import (
    ConvBNAct,
    MobileNetV2Encoder,
    apply_conv,
    round_channels,
)
from text_segmentation_image_inpainting_tpu_torch.ops.resize import resize_bilinear


class DilatedDecoder(nn.Module):
    """Dilated-conv decoder (mini-ASPP at rates 1/2/4) + bilinear upsample + skip concat."""

    def __init__(self, c_out_enc: int, c_s4: int, c_s2: int, mid: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.aspp = nn.ModuleList(
            [ConvBNAct(c_out_enc, mid, 3, dilation=d, act="leaky", dtype=dtype) for d in (1, 2, 4)]
        )
        self.fuse = ConvBNAct(3 * mid, mid, 1, act="leaky", dtype=dtype)
        self.skip4 = ConvBNAct(c_s4, 48, 1, act="leaky", dtype=dtype)
        self.dec4 = ConvBNAct(mid + 48, mid // 2, 3, act="leaky", dtype=dtype)
        self.skip2 = ConvBNAct(c_s2, 24, 1, act="leaky", dtype=dtype)
        self.dec2 = ConvBNAct(mid // 2 + 24, mid // 4, 3, act="leaky", dtype=dtype)
        self.head = nn.Conv2d(mid // 4, 1, 1)
        self.dtype = dtype

    def forward(self, taps: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([branch(taps["out"]) for branch in self.aspp], dim=-1)
        x = self.fuse(x)
        s4 = taps["s4"]
        x = resize_bilinear(x, s4.shape[1:3])
        x = self.dec4(torch.cat([x, self.skip4(s4)], dim=-1))
        s2 = taps["s2"]
        x = resize_bilinear(x, s2.shape[1:3])
        x = self.dec2(torch.cat([x, self.skip2(s2)], dim=-1))
        # the 1x1 head commutes with the bilinear resize (both linear, the
        # resize weights sum to 1), so it runs before the last upsample
        x = apply_conv(self.head, x.to(self.dtype))
        return resize_bilinear(x, (s2.shape[1] * 2, s2.shape[2] * 2))


class TextSegmenter(nn.Module):
    """img (N,H,W,3) -> text-mask logits (N,H,W,1)."""

    def __init__(self, width_mult: float = 1.0, output_stride: int = 8, decoder_mid: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = MobileNetV2Encoder(width_mult, output_stride, dtype=dtype)
        self.decoder = DilatedDecoder(
            self.encoder.out_channels, round_channels(24, width_mult),
            round_channels(32, width_mult), decoder_mid, dtype=dtype,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))

    @torch.no_grad()
    def predict_mask(self, x: torch.Tensor, *, threshold: float = 0.5) -> torch.Tensor:
        """Logits -> probability -> binary mask, in x.dtype."""
        return (torch.sigmoid(self(x)) > threshold).to(x.dtype)


# The reference spells its public class "TextSegament" (upstream's own
# spelling); keep the alias so reference users find it.
TextSegament = TextSegmenter
