"""Held-out validation helpers for the training CLI.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/val.py``: a
small FIXED validation set from a seed stream disjoint from training,
scored every log window. Over a rank mesh each val batch is sharded as
JAX shards it (``shard_batch``) and the eval steps made over the mesh
score the global batch, so every rank reports the global means.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from text_segmentation_image_inpainting_tpu_torch.data.pipeline import make_dataset, to_device
from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import shard_batch


def make_val_batches(kind: str, cfg, mesh=None, *, seed: int, n: int, device=None,
                     paths: Optional[Sequence[str]] = None) -> List[dict]:
    """n deterministic batches (empty when n == 0: the caller then scores
    the train batch): sharded over a rank ``mesh`` (this rank's rows of
    each), else whole on ``device``."""
    if n <= 0:
        return []
    if (mesh is None) == (device is None):
        raise ValueError("make_val_batches takes a rank mesh or a device")
    if mesh is not None and mesh.ranks is None:
        raise ValueError("make_val_batches shards over a rank mesh; pass a device mesh's "
                         "entries' device as device=")
    it = make_dataset(kind, batch_size=cfg.batch_size, size=cfg.image_size, seed=seed,
                      paths=paths)
    if mesh is None:
        return [to_device(next(it), device) for _ in range(n)]
    return [shard_batch(mesh, {k: np.asarray(v, np.float32) for k, v in next(it).items()})
            for _ in range(n)]


def scored_eval(eval_step, state, batches: Sequence[dict], *,
                prefix: str = "val_") -> Dict[str, float]:
    """Mean eval metrics over ``batches``, keys prefixed."""
    acc: Dict[str, List[float]] = {}
    for b in batches:
        for k, v in eval_step(state, b).items():
            acc.setdefault(k, []).append(float(v))
    return {prefix + k: sum(v) / len(v) for k, v in acc.items()}
