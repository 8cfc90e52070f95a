"""Model snapshots: save, tolerant load, parameter count.

Counterpart of ``text_segmentation_image_inpainting_tpu/models/base.py``,
over ``state_dict`` names in place of flax paths. A snapshot is one file
holding a module's ``state_dict`` (parameters and BatchNorm running
statistics). :func:`load_model` reads either format:

  * the port's own, written by :func:`save_model` (``torch.save``; read
    with ``weights_only=True``);
  * the JAX package's, written by its ``save_model`` (flax msgpack of the
    ``{"params", "batch_stats"[, "spectral"]}`` tree), decoded by ``compat/msgpack.py``
    and carried onto the module's names by ``compat/from_jax.py``, so a
    JAX-trained model is served on the card without jax.

Training checkpoints (the optimizer too) are ``train/checkpoint.py``'s.
"""

from __future__ import annotations

import logging
import zipfile
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

logger = logging.getLogger(__name__)


def total_parameters(module: nn.Module) -> int:
    """Number of scalar parameters (BatchNorm statistics are buffers, as
    they are outside flax's ``params``)."""
    return sum(p.numel() for p in module.parameters())


def _tensor(v) -> torch.Tensor:
    """A loaded value as a tensor (numpy arrays copied: they may be read-only)."""
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def tolerant_merge(target: Mapping[str, torch.Tensor], loaded: Mapping[str, Any], *,
                   prefix: str = "") -> Tuple[Dict[str, torch.Tensor], dict]:
    """Merge ``loaded`` into the state_dict ``target``, keeping only
    shape-matched keys.

    For every key of ``loaded`` (with ``prefix`` put before it) that
    ``target`` has with the same shape, take the loaded value in the
    target's dtype; otherwise keep the target's value and warn. Returns
    (merged, report); report maps 'used' / 'skipped_shape' /
    'skipped_missing' / 'unfilled' to lists of keys.
    """
    report = {"used": [], "skipped_shape": [], "skipped_missing": [], "unfilled": []}
    merged = dict(target)
    for k, v in loaded.items():
        key = prefix + k
        if key not in target:
            report["skipped_missing"].append(key)
            continue
        tv = target[key]
        if tuple(np.shape(v)) != tuple(tv.shape):
            logger.warning("tolerant_merge: shape mismatch at %s: loaded %s vs model %s — skipped",
                           key, tuple(np.shape(v)), tuple(tv.shape))
            report["skipped_shape"].append(key)
            continue
        merged[key] = _tensor(v).to(tv.dtype)
        report["used"].append(key)
    for k in target:
        if k not in loaded:
            report["unfilled"].append(k)
    # a snapshot whose keys do not match at all would otherwise leave the
    # module as it was without a word
    if loaded and not report["used"]:
        logger.warning("tolerant_merge: NO keys matched (%d loaded, %d skipped-missing) — "
                       "the merged tree is the template unchanged; wrong checkpoint layout?",
                       len(loaded), len(report["skipped_missing"]))
    elif loaded and len(report["used"]) < len(loaded) // 2:
        logger.warning("tolerant_merge: only %d/%d loaded keys matched "
                       "(%d skipped-missing, %d skipped-shape)",
                       len(report["used"]), len(loaded),
                       len(report["skipped_missing"]), len(report["skipped_shape"]))
    return merged, report


def save_model(path: str, module: nn.Module) -> None:
    """One-file snapshot of ``module``'s state_dict (``torch.save``): the
    parameters and the buffers, BatchNorm statistics and spectral norm's
    u and v included."""
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, path)


def _jax_state_dict(tree: Mapping[str, Any], module: nn.Module) -> Dict[str, np.ndarray]:
    """A JAX variable tree of ``module``'s kind onto its state_dict names
    (``compat/from_jax.py``)."""
    from text_segmentation_image_inpainting_tpu_torch.compat import from_jax
    from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import (
        MobileNetV2Encoder,
    )
    from text_segmentation_image_inpainting_tpu_torch.models.partial_convolution import (
        InpaintUNet,
    )
    from text_segmentation_image_inpainting_tpu_torch.models.text_segmentation import (
        TextSegmenter,
    )
    from text_segmentation_image_inpainting_tpu_torch.models.vgg import VGG16Features
    from text_segmentation_image_inpainting_tpu_torch.models.xception import XceptionEncoder

    layouts = ((TextSegmenter, from_jax.text_segmenter_state_dict),
               (InpaintUNet, from_jax.inpaint_unet_state_dict),
               (MobileNetV2Encoder, from_jax.mobilenet_v2_encoder_state_dict),
               (XceptionEncoder, from_jax.xception_encoder_state_dict),
               (VGG16Features, from_jax.vgg16_features_state_dict))
    for cls, build in layouts:
        if isinstance(module, cls):
            try:
                return build(tree)
            except KeyError as e:
                raise ValueError(f"the snapshot is not a {cls.__name__}'s variables: "
                                 f"no {e} in its tree") from None
    raise TypeError(f"no JAX snapshot layout for {type(module).__name__}; "
                    f"one of {', '.join(c.__name__ for c, _ in layouts)}")


def _read_snapshot(path: str, module: nn.Module) -> Dict[str, Any]:
    """The state_dict a snapshot file holds, in ``module``'s names."""
    if zipfile.is_zipfile(path):  # torch.save's format
        return torch.load(path, map_location="cpu", weights_only=True)
    from text_segmentation_image_inpainting_tpu_torch.compat.msgpack import unpackb

    with open(path, "rb") as f:
        return _jax_state_dict(unpackb(f.read()), module)


def load_model(path: str, module: nn.Module, *, tolerant: bool = True) -> nn.Module:
    """Load a snapshot (the port's or the JAX package's) into ``module``
    and return it. With ``tolerant=True`` shape-mismatched or missing
    entries keep the module's values, with warnings; otherwise every key
    must match (``load_state_dict(strict=True)``)."""
    state = _read_snapshot(path, module)
    if not tolerant:
        module.load_state_dict({k: _tensor(v) for k, v in state.items()}, strict=True)
        return module
    merged, report = tolerant_merge(module.state_dict(), state)
    module.load_state_dict(merged)
    if report["skipped_shape"] or report["skipped_missing"]:
        logger.warning("load_model: used %d, skipped %d (shape) / %d (missing)",
                       len(report["used"]), len(report["skipped_shape"]),
                       len(report["skipped_missing"]))
    return module
