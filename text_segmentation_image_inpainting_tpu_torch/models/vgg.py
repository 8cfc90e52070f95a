"""Frozen VGG16 feature extractor for the perceptual and style losses.

Counterpart of ``text_segmentation_image_inpainting_tpu/models/vgg.py``:
the torchvision ``vgg16().features`` trunk, tapped after pool1/pool2/
pool3, on ImageNet-normalised input. Parameter names are torchvision's
(``features.{i}.weight``), so a torchvision state_dict loads as it is
(``load_vgg16_state_dict``). The weights never train: the constructor
sets ``requires_grad=False``, and gradients flow through the activations
to the generator only.

One trunk serves both paths. ``apply_vgg_features(fused_stem=True)``
runs ``features[0:5]`` through ``ops.kernels.vgg_stem.vgg_stem_frozen``
(the same forward; its backward is kernel K4) and the rest of the trunk
as usual.
"""

from __future__ import annotations

from typing import List, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d
from text_segmentation_image_inpainting_tpu_torch.ops.kernels.vgg_stem import (
    max_pool_2x2,
    vgg_stem_frozen,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# torchvision vgg16.features layout; int = conv out-channels, 'M' = maxpool
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M")
STEM_LAYERS = 5  # features[0:5]: conv0, relu, conv1, relu, pool1


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std with the constants in x's dtype, as JAX does."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class VGG16Features(nn.Module):
    """(N,H,W,3) in [0,1] -> [pool1, pool2, pool3] feature taps (NHWC).

    ``features`` holds torchvision's layers up to the last tap: conv
    layers at their torchvision indices, ``nn.ReLU``/``nn.MaxPool2d``
    between them (they hold no parameters). Each conv computes in
    ``dtype`` from f32 weights: input, kernel and bias cast to ``dtype``,
    the bias added after the conv output is rounded, as flax ``nn.Conv``.
    """

    def __init__(self, num_taps: int = 3, normalize: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_taps = num_taps
        self.normalize = normalize
        self.dtype = dtype
        layers: List[nn.Module] = []
        c, pools = 3, 0
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                pools += 1
                if pools >= num_taps:
                    break
            else:
                layers += [nn.Conv2d(c, v, 3, padding=1), nn.ReLU()]
                c = v
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self._trunk(imagenet_normalize(x) if self.normalize else x, 0)

    def _trunk(self, y: torch.Tensor, start: int) -> List[torch.Tensor]:
        """Run ``features[start:]`` on NHWC ``y``; the taps after each pool
        (a stem output ``y`` counts as pool1 when ``start`` is 5)."""
        taps = [y] if start == STEM_LAYERS else []
        for layer in self.features[start:]:
            if isinstance(layer, nn.Conv2d):
                y = conv2d(y.to(self.dtype), layer.weight, layer.bias, padding=1)
            elif isinstance(layer, nn.ReLU):
                y = F.relu(y)
            else:
                y = max_pool_2x2(y)
                taps.append(y)
        return taps


def apply_vgg_features(model: VGG16Features, x: torch.Tensor, *,
                       fused_stem: bool = False) -> List[torch.Tensor]:
    """``model(x)``, with the stem's backward on kernel K4 when
    ``fused_stem``. The forward is the same either way. Where the geometry
    does not fit the fused stem (H or W not a multiple of 16, as the JAX
    gate) the stock path runs."""
    if not fused_stem or x.shape[1] % 16 or x.shape[2] % 16:
        return model(x)
    if model.normalize:
        x = imagenet_normalize(x)
    conv0, conv1 = model.features[0], model.features[2]
    y = vgg_stem_frozen(x, conv0.weight, conv0.bias, conv1.weight, conv1.bias, model.dtype)
    return model._trunk(y, STEM_LAYERS)


def load_vgg16_state_dict(model: VGG16Features, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a torchvision ``vgg16`` state_dict (or its ``features`` part):
    every parameter the trunk has must be there with its shape; the
    deeper layers and the classifier are ignored."""
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict]
    if missing:
        raise KeyError(f"the state_dict lacks {missing}")
    model.load_state_dict({k: torch.as_tensor(state_dict[k]) for k in own}, strict=True)
