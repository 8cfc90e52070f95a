"""Held-out validation helpers for the training CLI.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/val.py``,
without a mesh: a small FIXED validation set from a seed stream disjoint
from training, scored every log window.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from text_segmentation_image_inpainting_tpu_torch.data.pipeline import make_dataset, to_device


def make_val_batches(kind: str, cfg, *, seed: int, n: int, device,
                     paths: Optional[Sequence[str]] = None) -> List[dict]:
    """n deterministic batches on ``device`` (empty when n == 0: the
    caller then scores the train batch)."""
    if n <= 0:
        return []
    it = make_dataset(kind, batch_size=cfg.batch_size, size=cfg.image_size, seed=seed,
                      paths=paths)
    return [to_device(next(it), device) for _ in range(n)]


def scored_eval(eval_step, state, batches: Sequence[dict], *,
                prefix: str = "val_") -> Dict[str, float]:
    """Mean eval metrics over ``batches``, keys prefixed."""
    acc: Dict[str, List[float]] = {}
    for b in batches:
        for k, v in eval_step(state, b).items():
            acc.setdefault(k, []).append(float(v))
    return {prefix + k: sum(v) / len(v) for k, v in acc.items()}
