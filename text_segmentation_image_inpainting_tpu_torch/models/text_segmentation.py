"""Text-segmentation model: an encoder (MobileNetV2 or Xception) and a
decoder (the dilated mini-ASPP or DeepLab-v3+'s ASPP).

Counterpart of ``text_segmentation_image_inpainting_tpu/models/text_segmentation.py``.
Pages are NHWC, logits (N, H, W, 1). State_dict names follow the torch
oracle (``encoder.*``, ``decoder.aspp.{i}``, ``decoder.head``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import (
    ConvBNAct,
    MobileNetV2Encoder,
    apply_conv,
    flax_init_,
    round_channels,
)
from text_segmentation_image_inpainting_tpu_torch.models.xception import XceptionEncoder
from text_segmentation_image_inpainting_tpu_torch.ops.bands import mean_hw
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


class DeepLabASPPDecoder(nn.Module):
    """DeepLab-v3+ head: the full ASPP (a 1x1 branch, three dilated 3x3
    branches and image-level pooling) over the encoder output, then the
    v3+ decoder (upsample to s4, a 48-channel skip concat, two 3x3
    refiners, the 1-channel head before the x4 upsample). Rates (12, 24,
    36) at output stride <= 8, else (6, 12, 18)."""

    def __init__(self, c_out_enc: int, c_s4: int, mid: int = 256, output_stride: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        scale = 12 if output_stride <= 8 else 6
        self.aspp = nn.ModuleList(
            [ConvBNAct(c_out_enc, mid, 1, act="relu", dtype=dtype)]
            + [ConvBNAct(c_out_enc, mid, 3, dilation=r, act="relu", dtype=dtype)
               for r in (scale, 2 * scale, 3 * scale)]
        )
        self.image_pool = ConvBNAct(c_out_enc, mid, 1, act="relu", dtype=dtype)
        self.fuse = ConvBNAct(5 * mid, mid, 1, act="relu", dtype=dtype)
        self.skip4 = ConvBNAct(c_s4, 48, 1, act="relu", dtype=dtype)
        self.dec0 = ConvBNAct(mid + 48, mid, 3, act="relu", dtype=dtype)
        self.dec1 = ConvBNAct(mid, mid, 3, act="relu", dtype=dtype)
        self.head = nn.Conv2d(mid, 1, 1)
        self.mid = mid
        self.dtype = dtype

    def forward(self, taps: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = taps["out"]
        branches = [branch(out) for branch in self.aspp]
        # image-level pooling (global context), broadcast back; over the
        # whole page when the encoder runs on H bands (ops/bands.py)
        pooled = self.image_pool(mean_hw(out))
        branches.append(pooled.expand(*out.shape[:3], self.mid))
        x = self.fuse(torch.cat(branches, dim=-1))
        s4 = taps["s4"]
        x = resize_bilinear(x, s4.shape[1:3])
        x = torch.cat([x, self.skip4(s4)], dim=-1)
        x = self.dec1(self.dec0(x))
        # the 1x1 head before the x4 upsample (both linear), as in DilatedDecoder
        x = apply_conv(self.head, x.to(self.dtype))
        return resize_bilinear(x, (s4.shape[1] * 4, s4.shape[2] * 4))


class TextSegmenter(nn.Module):
    """img (N,H,W,3) -> text-mask logits (N,H,W,1).

    ``backbone``: 'mobilenet_v2' (the reference's) or 'xception'
    (``middle_repeats`` middle blocks). ``head``: 'mini' (the dilated
    decoder) or 'deeplab' (the full ASPP, at least 256 channels wide)."""

    def __init__(self, width_mult: float = 1.0, output_stride: int = 8, decoder_mid: int = 128,
                 backbone: str = "mobilenet_v2", head: str = "mini", middle_repeats: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if backbone == "xception":
            self.encoder = XceptionEncoder(width_mult, output_stride, middle_repeats, dtype=dtype)
            c_s4, c_s2 = self.encoder.s4_channels, self.encoder.s2_channels
        elif backbone == "mobilenet_v2":
            self.encoder = MobileNetV2Encoder(width_mult, output_stride, dtype=dtype)
            c_s4, c_s2 = round_channels(24, width_mult), round_channels(32, width_mult)
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        if head == "deeplab":
            self.decoder = DeepLabASPPDecoder(self.encoder.out_channels, c_s4,
                                              max(decoder_mid, 256), output_stride, dtype=dtype)
        elif head == "mini":
            self.decoder = DilatedDecoder(self.encoder.out_channels, c_s4, c_s2, decoder_mid,
                                          dtype=dtype)
        else:
            raise ValueError(f"unknown head {head!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))

    def init_weights(self, generator: torch.Generator | None = None) -> "TextSegmenter":
        """flax's initialisers, as the JAX model's ``init``: LeCun-normal
        kernels (``flax_init_``), biases 0, BatchNorm the identity."""
        flax_init_(self, 1.0, generator)
        return self

    @torch.no_grad()
    def predict_mask(self, x: torch.Tensor, *, threshold: float = 0.5) -> torch.Tensor:
        """Logits -> probability -> binary mask, in x.dtype."""
        return (torch.sigmoid(self(x)) > threshold).to(x.dtype)


# The reference spells its public class "TextSegament" (upstream's own
# spelling); keep the alias so reference users find it.
TextSegament = TextSegmenter
