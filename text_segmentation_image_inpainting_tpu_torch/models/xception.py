"""Aligned-Xception-style encoder: the alternative-backbone track.

Counterpart of ``text_segmentation_image_inpainting_tpu/models/xception.py``:
DeepLab-v3+'s modified Xception (an entry flow of two conv stems and
three strided separable blocks, ``middle_repeats`` residual middle
blocks, an exit flow of one strided block and two separable convs to
2048 channels), with the taps {'s2', 's4', 'out'} of
``MobileNetV2Encoder`` and its stride -> dilation swap past
``output_stride``. State_dict names follow the torch oracle: ``stem1``,
``stem2``, ``entry.{i}``, ``mid.{r}``, ``exit0``, ``exit1``, ``exit2``;
a block's ``seps.{i}`` (``dw``, ``pw``) and ``skip``.

The separable convs are the port's own ``ConvBNAct`` with
``groups=cin``, so ``ops/depthwise.py::supports`` routes the same layers
as JAX: with ``USE_CUSTOM_WGRAD`` on, every stride-1 depthwise conv with
C >= 128 takes its weight gradient from K6.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import (
    ConvBNAct,
    round_channels,
)

# entry-flow blocks (each nominally stride 2)
XCEPTION_ENTRY: Tuple[Tuple[int, ...], ...] = (
    (128, 128, 128),
    (256, 256, 256),
    (728, 728, 728),
)
XCEPTION_EXIT: Tuple[int, ...] = (728, 1024, 1024)
XCEPTION_EXIT_SEPS: Tuple[int, ...] = (1536, 2048)


class SeparableConv(nn.Module):
    """Depthwise 3x3 (stride, dilation) + pointwise 1x1, each Conv-BN-ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dw = ConvBNAct(cin, cin, 3, stride=stride, dilation=dilation, groups=cin,
                            act="relu", dtype=dtype)
        self.pw = ConvBNAct(cin, cout, 1, act="relu", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


class XceptionBlock(nn.Module):
    """Separable convs (the stride on the last) + a skip: the identity at
    stride 1 with matching channels (middle flow), else a 1x1 conv + BN."""

    def __init__(self, cin: int, features: Sequence[int], stride: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        seps, c = [], cin
        for i, f in enumerate(features):
            s = stride if i == len(features) - 1 else 1
            seps.append(SeparableConv(c, f, stride=s, dilation=dilation, dtype=dtype))
            c = f
        self.seps = nn.ModuleList(seps)
        cout = features[-1]
        self.skip = (None if stride == 1 and cin == cout
                     else ConvBNAct(cin, cout, 1, stride=stride, act="none", dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for sep in self.seps:
            h = sep(h)
        return (x if self.skip is None else self.skip(x)) + h


def _stride_plan(output_stride: int, n_strided: int):
    """(stride, dilation) per nominally strided stage under the DeepLab
    stride -> dilation swap, starting after the stride-2 stem."""
    plan = []
    current, dilation = 2, 1
    for _ in range(n_strided):
        if current >= output_stride:
            plan.append((1, dilation))
            dilation *= 2
        else:
            plan.append((2, dilation))
            current *= 2
    return plan


class XceptionEncoder(nn.Module):
    """Backbone returning the taps {'s2', 's4', 'out'} (NHWC)."""

    def __init__(self, width_mult: float = 1.0, output_stride: int = 8, middle_repeats: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        wm = width_mult
        self.stem1 = ConvBNAct(3, round_channels(32, wm), 3, stride=2, act="relu", dtype=dtype)
        self.stem2 = ConvBNAct(round_channels(32, wm), round_channels(64, wm), 3, act="relu",
                               dtype=dtype)
        plan = _stride_plan(output_stride, len(XCEPTION_ENTRY) + 1)
        cin, entries = round_channels(64, wm), []
        for bi, chans in enumerate(XCEPTION_ENTRY):
            stride, d = plan[bi]
            feats = [round_channels(c, wm) for c in chans]
            entries.append(XceptionBlock(cin, feats, stride=stride, dilation=d, dtype=dtype))
            cin = feats[-1]
        self.entry = nn.ModuleList(entries)
        # the middle flow runs at the dilation the entry flow ends with
        last_stride, last_d = plan[len(XCEPTION_ENTRY) - 1]
        mid_d = last_d * (2 if last_stride == 1 else 1)
        mid_c = round_channels(XCEPTION_ENTRY[-1][-1], wm)
        self.mid = nn.ModuleList([XceptionBlock(mid_c, (mid_c,) * 3, dilation=mid_d, dtype=dtype)
                                  for _ in range(middle_repeats)])
        stride, d = plan[len(XCEPTION_ENTRY)]
        feats = [round_channels(c, wm) for c in XCEPTION_EXIT]
        self.exit0 = XceptionBlock(cin, feats, stride=stride, dilation=d, dtype=dtype)
        exit_d = d * (2 if stride == 1 else 1)
        cin = feats[-1]
        c1, c2 = (round_channels(c, wm) for c in XCEPTION_EXIT_SEPS)
        self.exit1 = SeparableConv(cin, c1, dilation=exit_d, dtype=dtype)
        self.exit2 = SeparableConv(c1, c2, dilation=exit_d, dtype=dtype)
        self.out_channels = c2
        self.s4_channels = round_channels(XCEPTION_ENTRY[0][-1], wm)
        self.s2_channels = round_channels(64, wm)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps: Dict[str, torch.Tensor] = {}
        x = self.stem2(self.stem1(x))
        taps["s2"] = x
        for bi, block in enumerate(self.entry):
            x = block(x)
            if bi == 0:
                taps["s4"] = x
        for block in self.mid:
            x = block(x)
        taps["out"] = self.exit2(self.exit1(self.exit0(x)))
        return taps
