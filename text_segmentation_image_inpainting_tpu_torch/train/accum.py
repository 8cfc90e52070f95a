"""Microbatched gradient accumulation.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/accum.py``:
one batch is split into ``k`` microbatches, each runs its own forward and
backward in order (so BatchNorm statistics and spectral norm's u and v
move through the microbatches as k small steps would move them), and the
step sees the microbatch MEAN of the gradients and of the loss terms, for
one optimizer update. Normalisation layers see per-microbatch batch
statistics, so the accumulated step equals the big-batch step exactly
only when the microbatches are statistically interchangeable (duplicated
halves, as the tests use).

Under ``ops/collectives.py::data_parallel`` (a step over a rank mesh,
``parallel/mesh.py``) each rank holds an equal shard of the global batch
and its loss terms are its shares of the global loss, so after the last
microbatch one collective sums the ranks' gradients and terms: every rank
then holds the global loss's gradient, as GSPMD's step computes it, and
the global terms. A microbatch takes the same strided rows of every
rank's shard, so it spans every rank, as JAX's does.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch

from text_segmentation_image_inpainting_tpu_torch.ops import collectives


def microbatches(batch: Dict[str, torch.Tensor], k: int):
    """The ``k`` microbatches of ``batch``: microbatch j holds samples
    j, k + j, 2k + j, ... (a STRIDED split, as JAX's: under data
    parallelism each microbatch spans every device)."""
    if k < 1:
        raise ValueError(f"grad_accum must be >= 1, got {k}")
    n = next(iter(batch.values())).shape[0]
    if n % k != 0:
        raise ValueError(f"batch size {n} not divisible by grad_accum {k}")
    return [{key: v[j::k] for key, v in batch.items()} for j in range(k)]


def accumulate_grads(micro_step: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                     batch: Dict[str, torch.Tensor], k: int,
                     params: Iterable[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Run ``micro_step`` on each of the ``k`` microbatches of ``batch``
    and leave the mean gradient in each of ``params``' ``.grad``.

    ``micro_step(microbatch)`` runs one forward and backward (its
    gradients add into ``.grad``, which must be clear before the first)
    and returns its loss terms, detached. Returns the terms' means. With
    k == 1 it is ``micro_step(batch)``, with the ranks' sums taken under
    ``data_parallel``.
    """
    params = list(params)
    tsum: Dict[str, torch.Tensor] = {}
    for mb in microbatches(batch, k):
        for name, t in micro_step(mb).items():
            tsum[name] = tsum[name] + t if name in tsum else t
    if k > 1:
        inv = 1.0 / k
        for p in params:
            if p.grad is not None:
                p.grad.mul_(inv)
        tsum = {name: t * inv for name, t in tsum.items()}
    if collectives.active() is not None:
        collectives.all_reduce_sum_([p.grad for p in params if p.grad is not None]
                                    + list(tsum.values()))
    return tsum
