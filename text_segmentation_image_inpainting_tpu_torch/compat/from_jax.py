"""flax variables -> this package's ``state_dict``, with numpy alone.

The JAX package trains and checkpoints flax variable trees
(``{"params": ..., "batch_stats": ...}``). This bridge maps such a tree,
with numpy arrays (or anything ``np.asarray`` takes) as leaves, onto the
parameter names of ``models/``:

  conv kernel  HWIO -> OIHW (a depthwise (kh,kw,1,C) becomes (C,1,kh,kw))
  conv bias    as is
  BatchNorm    scale -> weight, bias -> bias, batch_stats mean/var ->
               running_mean/running_var, num_batches_tracked = 0
  spectral     the 'spectral' collection's u/v -> the conv's buffers u/v
  gamma        as is (the attention block's 0-d gate)

It reads the block structure from the tree itself (how many MobileNetV2
blocks, which have an expand layer, which backbone and head a segmenter
has, how deep the U-Net is, whether it has an attention block), so it
needs no model code from either package and never imports jax or flax.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


class _Tree:
    def __init__(self, variables: Mapping[str, Any]):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.spectral = variables.get("spectral", {})
        self.out: Dict[str, np.ndarray] = {}

    @staticmethod
    def _at(tree, path):
        for p in path:
            tree = tree[p]
        return tree

    def conv(self, path, key):
        node = self._at(self.params, path)
        self.out[key + ".weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in node:
            self.out[key + ".bias"] = np.asarray(node["bias"])

    def bn(self, path, key):
        p, s = self._at(self.params, path), self._at(self.stats, path)
        self.out[key + ".weight"] = np.asarray(p["scale"])
        self.out[key + ".bias"] = np.asarray(p["bias"])
        self.out[key + ".running_mean"] = np.asarray(s["mean"])
        self.out[key + ".running_var"] = np.asarray(s["var"])
        self.out[key + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def spectral_conv(self, path, key):
        """A ``SpectralNormConv2d``: its kernel (and bias) and u/v."""
        self.conv(path, key)
        s = self._at(self.spectral, path)
        self.out[key + ".u"] = np.asarray(s["u"])
        self.out[key + ".v"] = np.asarray(s["v"])

    def conv_bn(self, path, key):
        """A ``ConvBNAct``: flax ``conv``/``bn`` -> children ``0``/``1``."""
        self.conv(path + ("conv",), key + ".0")
        self.bn(path + ("bn",), key + ".1")


def _indices(names, pattern: str):
    return sorted(int(m.group(1)) for n in names if (m := re.fullmatch(pattern, n)))


def _encoder(t: _Tree, path: tuple, prefix: str) -> None:
    t.conv_bn(path + ("stem",), prefix + "stem")
    for i in _indices(t._at(t.params, path), r"block(\d+)"):
        bpath, key = path + (f"block{i}",), f"{prefix}blocks.{i}.block"
        j = 0
        if "expand" in t._at(t.params, bpath):
            t.conv_bn(bpath + ("expand",), f"{key}.{j}")
            j += 1
        t.conv_bn(bpath + ("depthwise",), f"{key}.{j}")
        t.conv(bpath + ("project_conv",), f"{key}.{j + 1}")
        t.bn(bpath + ("project_bn",), f"{key}.{j + 2}")


def _xception(t: _Tree, path: tuple, prefix: str) -> None:
    def block(bpath, key):
        for i in _indices(t._at(t.params, bpath), r"sep(\d+)"):
            t.conv_bn(bpath + (f"sep{i}", "dw"), f"{key}.seps.{i}.dw")
            t.conv_bn(bpath + (f"sep{i}", "pw"), f"{key}.seps.{i}.pw")
        if "skip" in t._at(t.params, bpath):
            t.conv_bn(bpath + ("skip",), f"{key}.skip")

    names = t._at(t.params, path)
    for name in ("stem1", "stem2"):
        t.conv_bn(path + (name,), prefix + name)
    for i in _indices(names, r"entry(\d+)"):
        block(path + (f"entry{i}",), f"{prefix}entry.{i}")
    for r in _indices(names, r"mid(\d+)"):
        block(path + (f"mid{r}",), f"{prefix}mid.{r}")
    block(path + ("exit0",), prefix + "exit0")
    for name in ("exit1", "exit2"):
        t.conv_bn(path + (name, "dw"), f"{prefix}{name}.dw")
        t.conv_bn(path + (name, "pw"), f"{prefix}{name}.pw")


def xception_encoder_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``XceptionEncoder`` variables (any width, output stride and middle depth)."""
    t = _Tree(variables)
    _xception(t, (), "")
    return t.out


def mobilenet_v2_encoder_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``MobileNetV2Encoder`` variables (any width and output stride)."""
    t = _Tree(variables)
    _encoder(t, (), "")
    return t.out


def text_segmenter_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``TextSegmenter`` variables, of either backbone and either head."""
    t = _Tree(variables)
    if "stem1" in t.params["encoder"]:
        _xception(t, ("encoder",), "encoder.")
    else:
        _encoder(t, ("encoder",), "encoder.")
    dec = ("decoder",)
    if "image_pool" in t.params["decoder"]:  # DeepLabASPPDecoder
        for i in range(4):
            t.conv_bn(dec + (f"aspp{i}",), f"decoder.aspp.{i}")
        names = ("image_pool", "fuse", "skip4", "dec0", "dec1")
    else:
        for i in range(3):
            t.conv_bn(dec + (f"aspp{i}",), f"decoder.aspp.{i}")
        names = ("fuse", "skip4", "dec4", "skip2", "dec2")
    for name in names:
        t.conv_bn(dec + (name,), f"decoder.{name}")
    t.conv(dec + ("head",), "decoder.head")
    return t.out


def inpaint_unet_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``InpaintUNet`` variables (any depth, with or without the attention
    block; the decoder's ``dec{lvl}`` becomes ``dec_convs.{depth-1-lvl}``,
    the deepest level first)."""
    t = _Tree(variables)
    depth = len(_indices(t.params, r"enc(\d+)"))
    for i in range(depth):
        t.conv((f"enc{i}",), f"enc_convs.{i}.conv")
        if f"enc{i}_bn" in t.params:
            t.bn((f"enc{i}_bn",), f"enc_bns.{i}")
    if "attn" in t.params:
        spectral = "attn" in t.spectral
        for name in ("query", "key", "value", "out"):
            (t.spectral_conv if spectral else t.conv)(("attn", name), f"attn.{name}")
        t.out["attn.gamma"] = np.asarray(t.params["attn"]["gamma"])
    for j in range(depth - 1):
        lvl = depth - 1 - j
        t.conv((f"dec{lvl}",), f"dec_convs.{j}.conv")
        t.bn((f"dec{lvl}_bn",), f"dec_bns.{j}")
    t.conv(("head",), "head.conv")
    return t.out


def vgg16_conv_indices():
    """torchvision ``vgg16.features`` index of each conv: a conv is
    followed by its relu, a pool stands alone."""
    idx, out = 0, []
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"):
        if v == "M":
            idx += 1
        else:
            out.append(idx)
            idx += 2
    return out


def vgg16_features_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``VGG16Features`` variables (flax ``conv{j}``) -> torchvision names
    ``features.{i}`` (as many convs as the tree holds)."""
    t = _Tree(variables)
    for j, idx in enumerate(vgg16_conv_indices()[: len(_indices(t.params, r"conv(\d+)"))]):
        t.conv((f"conv{j}",), f"features.{idx}")
    return t.out


def load_state_dict(module: torch.nn.Module, state_dict: Mapping[str, np.ndarray]) -> None:
    """``module.load_state_dict(..., strict=True)`` from numpy arrays."""
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()},
        strict=True,
    )
