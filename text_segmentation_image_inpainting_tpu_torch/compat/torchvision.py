"""torchvision checkpoints -> this package's ``state_dict`` names.

Counterpart of the torchvision half of
``text_segmentation_image_inpainting_tpu/compat/torch_import.py``. The
reference trains its segmenter from an ImageNet-pretrained torchvision
``mobilenet_v2`` and computes its perceptual and style losses on a
torchvision ``vgg16`` trunk. Both files are plain ``state_dict``s:

  mobilenet_v2  features.0.{0,1}                 -> stem.{0,1}
                features.{i}.conv.{j}[.{k}]      -> blocks.{i-1}.block.{j}[.{k}]
                features.18.*, classifier.*      dropped (not the encoder)
  vgg16         features.{0,2,5,7,10,12,14}.*    kept (the trunk to pool3)
                deeper features, classifier.*    dropped

The port keeps torch's tensor layout (OIHW), so only names change. Every
function here works on ``{name: tensor or ndarray}`` mappings and returns
the values it was given; ``tolerant_import`` loads them into a module
through ``models/base.py::tolerant_merge``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn as nn

from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import vgg16_conv_indices
from text_segmentation_image_inpainting_tpu_torch.models.base import tolerant_merge
from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import MOBILENETV2_CONFIG

logger = logging.getLogger(__name__)

# what a torchvision conv or BatchNorm module holds
_SUFFIXES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
# the VGG16 trunk to pool3 (VGG16Features' three taps): its 7 convs
VGG16_TRUNK_CONVS = 7


def mobilenet_name_pairs() -> List[Tuple[str, str]]:
    """(torchvision module, port module) for every conv and BatchNorm of
    ``mobilenet_v2``'s 17 inverted-residual blocks and stem. A t = 1 block
    is depthwise ConvBNAct, project conv, project BN (4 pairs); a t = 6
    block puts the expand ConvBNAct first (6 pairs)."""
    pairs = [("features.0.0", "stem.0"), ("features.0.1", "stem.1")]
    idx = 0
    for t, _, n, _ in MOBILENETV2_CONFIG:
        subs = ("0.0", "0.1", "1", "2") if t == 1 else ("0.0", "0.1", "1.0", "1.1", "2", "3")
        for _ in range(n):
            pairs += [(f"features.{idx + 1}.conv.{s}", f"blocks.{idx}.block.{s}") for s in subs]
            idx += 1
    return pairs


def torchvision_mobilenet_v2_state_dict(sd: Mapping[str, Any], *,
                                        prefix: str = "") -> Dict[str, Any]:
    """A torchvision ``mobilenet_v2`` state_dict in ``MobileNetV2Encoder``'s
    names (``prefix="encoder."`` for a whole ``TextSegmenter``). Keys off
    the table, ``features.18.*`` and ``classifier.*`` among them, are
    dropped; a key the file lacks is simply absent."""
    out = {}
    for tv, port in mobilenet_name_pairs():
        for suffix in _SUFFIXES:
            if f"{tv}.{suffix}" in sd:
                out[f"{prefix}{port}.{suffix}"] = sd[f"{tv}.{suffix}"]
    return out


def vgg16_features_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A torchvision ``vgg16`` state_dict cut to ``VGG16Features``' trunk:
    ``features.{0,2,5,7,10,12,14}``, as JAX's ``import_vgg16_features``."""
    keep = {f"features.{i}.{p}" for i in vgg16_conv_indices()[:VGG16_TRUNK_CONVS]
            for p in ("weight", "bias")}
    return {k: v for k, v in sd.items() if k in keep}


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load`` a checkpoint (tensors only) to the CPU; a saved
    module gives its ``state_dict``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd)


def tolerant_import(module: nn.Module, sd: Mapping[str, Any]) -> dict:
    """Load the shape-matched entries of ``sd`` into ``module``; the rest
    keep the module's values. Logs one line (as JAX's ``tolerant_import``)
    so that a file whose layout matches nothing never passes silently, and
    returns ``tolerant_merge``'s report."""
    merged, report = tolerant_merge(module.state_dict(), sd)
    module.load_state_dict(merged)
    logger.info("tolerant_import: used %d, skipped %d (missing) / %d (shape), unfilled %d",
                len(report["used"]), len(report["skipped_missing"]),
                len(report["skipped_shape"]), len(report["unfilled"]))
    return report
