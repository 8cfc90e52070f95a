"""MobileNetV2 encoder (Sandler et al. 2018), dilated for dense prediction.

Counterpart of ``text_segmentation_image_inpainting_tpu/models/mobilenet_v2.py``.
Activations are NHWC; parameters keep torch's layout and the torch
oracle's state_dict names (``stem.0``, ``blocks.{i}.block.{j}``). Each
layer computes in the module's ``dtype`` from f32 parameters, as the
flax modules do. BatchNorm trains in flax's arithmetic (see ``BatchNorm``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d, torch_same_padding

# (expansion t, out channels c, repeats n, first-block stride s)
MOBILENETV2_CONFIG: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def round_channels(c: float, width_mult: float, divisor: int = 8) -> int:
    """MobileNet channel rounding (multiple of 8; never below 90%)."""
    c = c * width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


_ACTS = {
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "relu": F.relu,
    "leaky": lambda x: F.leaky_relu(x, 0.2),
    "selu": F.selu,
    "none": lambda x: x,
}


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm on NHWC input, in flax's arithmetic (flax
    ``BatchNorm(dtype=bf16, param_dtype=f32, momentum=0.9, epsilon=1e-5)``):
    the statistics and affine stay f32, the input is promoted to f32 and
    the result cast back to the input's dtype.

    In training mode (unless ``frozen``) it normalises with the batch's
    mean and variance, taken in f32 over N, H, W as flax's
    ``_compute_stats`` takes them (var = max(E[x^2] - E[x]^2, 0)), and
    moves the running statistics by ``r = 0.9 r + 0.1 batch`` with the
    BIASED batch variance. ``F.batch_norm(training=True)`` would update
    ``running_var`` with the unbiased one, so it is not used.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, *, frozen: bool = False) -> torch.Tensor:
        xf = x.float()
        if self.training and not frozen:
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.clamp((xf * xf).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = xf - mean
        y = y * (torch.rsqrt(var + self.eps) * self.weight)
        y = y + self.bias
        return y.to(x.dtype)


def apply_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Run ``conv``'s parameters and geometry on NHWC ``x`` (in x.dtype)."""
    return conv2d(
        x, conv.weight, conv.bias, stride=conv.stride, padding=conv.padding,
        dilation=conv.dilation, groups=conv.groups,
    )


class ConvBNAct(nn.Sequential):
    """Conv -> BatchNorm -> activation; children ``0`` (conv) and ``1`` (bn)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1, act: str = "relu6",
                 dtype: torch.dtype = torch.float32):
        pad = torch_same_padding(kernel_size, dilation)
        super().__init__(
            nn.Conv2d(cin, cout, kernel_size, stride, pad, dilation=dilation, groups=groups,
                      bias=False),
            BatchNorm(cout),
        )
        if act not in _ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ACTS[self.act](self[1](apply_conv(self[0], x.to(self.dtype))))


class InvertedResidual(nn.Module):
    """1x1 expand -> 3x3 depthwise (stride/dilation) -> 1x1 linear project,
    residual add when stride 1 and channels match."""

    def __init__(self, cin: int, cout: int, stride: int = 1, expand_ratio: int = 6,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNAct(cin, hidden, 1, dtype=dtype))
        layers.append(ConvBNAct(hidden, hidden, 3, stride=stride, dilation=dilation,
                                groups=hidden, dtype=dtype))
        layers.append(nn.Conv2d(hidden, cout, 1, bias=False))
        layers.append(BatchNorm(cout))
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *cbas, project, bn = self.block
        h = x
        for layer in cbas:
            h = layer(h)
        h = bn(apply_conv(project, h.to(self.dtype)))
        return x + h if self.use_res else h


def _plan_blocks(width_mult: float, output_stride: int):
    """Static block plan: list of (features, stride, expand, dilation[, tap])."""
    plan = []
    current_stride = 2  # after stem
    dilation = 1
    for t, c, n, s in MOBILENETV2_CONFIG:
        cout = round_channels(c, width_mult)
        for i in range(n):
            want = s if i == 0 else 1
            d, stride = dilation, want
            if want > 1:
                if current_stride >= output_stride:
                    # stride -> dilation swap: THIS block keeps the previous
                    # dilation; subsequent blocks dilate
                    stride = 1
                    d = dilation
                    dilation *= want
                else:
                    current_stride *= want
            plan.append((cout, stride, t, d))
        if c == 24:
            plan[-1] = plan[-1] + ("s4",)
    return plan


class MobileNetV2Encoder(nn.Module):
    """Backbone returning multi-scale taps {'s2', 's4', 'out'} (NHWC).

    ``output_stride`` in {8, 16, 32}: stages whose nominal stride would
    exceed it run at stride 1 with growing dilation instead.
    """

    def __init__(self, width_mult: float = 1.0, output_stride: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = round_channels(32, width_mult)
        self.stem = ConvBNAct(3, cin, 3, stride=2, dtype=dtype)
        self.taps = {}
        blocks = []
        for idx, entry in enumerate(_plan_blocks(width_mult, output_stride)):
            cout, stride, t, d = entry[:4]
            blocks.append(InvertedResidual(cin, cout, stride, t, dilation=d, dtype=dtype))
            if len(entry) == 5:
                self.taps[idx] = entry[4]
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps: Dict[str, torch.Tensor] = {}
        x = self.stem(x)
        taps["s2"] = x
        for idx, block in enumerate(self.blocks):
            x = block(x)
            if idx in self.taps:
                taps[self.taps[idx]] = x
        taps["out"] = x
        return taps
