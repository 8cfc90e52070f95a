"""Data-parallel collectives: the cross-rank sums of one global-batch step.

JAX trains data-parallel by GSPMD over a batch-sharded global array, so
every reduction over the batch (BatchNorm's statistics, the loss's sums
and means) is taken over the global batch and the gradient is that of the
global loss. The port runs one process per device (``torch.distributed``,
``parallel/mesh.py``). Under ``data_parallel(group, size)`` the layers
that reduce over the batch take their sums across the group's ranks, each
rank holding an equal shard of the global batch:

* ``all_reduce_stats`` sums a tensor over the ranks, differentiably: its
  backward sums the cotangent over the ranks, so the gradient through
  BatchNorm's statistics crosses ranks as GSPMD's does;
* ``global_sum`` sums without a gradient (the loss's mask denominators);
* ``local_share`` divides a per-rank mean by the number of ranks, so that
  the ranks' losses add up to the global loss;
* ``all_reduce_sum_`` sums tensors in place over the ranks, one collective
  per dtype (the gradients and loss terms after the backward).

The per-thread scope mirrors ``ops/bands.py::spatial_axis``. Outside
it every function is the identity and no collective runs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterable, NamedTuple

import torch

_ctx = threading.local()


class DataParallel(NamedTuple):
    group: object  # a torch.distributed process group
    size: int


@contextlib.contextmanager
def data_parallel(group, size: int):
    """Run this thread's layers as one rank of a ``size``-rank group."""
    prev = getattr(_ctx, "dp", None)
    _ctx.dp = DataParallel(group, int(size))
    try:
        yield
    finally:
        _ctx.dp = prev


def active() -> DataParallel | None:
    """The scope's group and size, or None outside ``data_parallel``."""
    return getattr(_ctx, "dp", None)


def dp_world() -> int:
    """The number of ranks of the active scope (1 outside it)."""
    dp = active()
    return 1 if dp is None else dp.size


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks forward; the cotangent summed over them backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_stats(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the scope's ranks, with a gradient (BatchNorm)."""
    dp = active()
    return x if dp is None else _AllReduceSum.apply(x, dp.group)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the scope's ranks, without a gradient."""
    dp = active()
    if dp is None:
        return x
    import torch.distributed as dist

    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=dp.group)
    return out


def local_share(x: torch.Tensor) -> torch.Tensor:
    """A mean over this rank's equal shard as its share of the global
    mean: ``x / size`` (``x`` itself with one rank)."""
    n = dp_world()
    return x if n == 1 else x / n


def flat_apply_(tensors: Iterable[torch.Tensor], collective) -> None:
    """Run ``collective`` (in place, on one tensor) once per dtype over the
    flattened concatenation of ``tensors``, and copy the result back."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            collective(flat)
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))


def all_reduce_sum_(tensors: Iterable[torch.Tensor]) -> None:
    """Sum ``tensors`` in place over the scope's ranks: one collective per
    dtype over their flattened concatenation. Nothing outside the scope."""
    dp = active()
    if dp is None:
        return
    import torch.distributed as dist

    flat_apply_(tensors, lambda flat: dist.all_reduce(flat, group=dp.group))
