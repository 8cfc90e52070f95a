"""Multi-step dispatch: k train steps per call, on CUDA as a CUDA graph.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/multistep.py``,
where ``lax.scan`` runs k steps in one jitted dispatch. Here
``make_multi_step(train_step)`` gives ``multi_step(state, batches)`` over
batches stacked ``(k, ...)``, returning metrics stacked ``(k,)``. The
route follows the batches' device alone:

* CPU: a plain loop of ``train_step``. So is a step made over a rank mesh
  whose group is not NCCL's (gloo's collectives run on the host and cannot
  be captured).
* CUDA: the step is captured once per state and batch shape into a
  ``torch.cuda.CUDAGraph`` and replayed. The first call's first step runs
  eagerly on a side stream: it is the warm-up, which builds the kernels,
  the optimizer's state, the partial conv's window weights and K6's
  workspace, so nothing is created or grown inside the capture. Then the
  step is captured from static input buffers and every later step is one
  replay, after copying its batch into those buffers on the device. The
  state must be capturable (``create_train_state(capturable=True)``: Adam
  with ``capturable=True`` and a device learning rate that the schedule
  moves in place). The captured step starts from cleared gradients and
  clears them again, so each replay writes its gradients afresh into the
  graph's own buffers: nothing accumulates across replays. BatchNorm
  statistics and spectral norm's u and v are updated in place, so the
  replays carry them. ``TrainState.step`` stays the host's count, and the
  kernels' launch counters count the warm-up and the capture, not the
  replays. A step over an NCCL rank mesh captures its collectives (the
  BatchNorm statistics' and the gradients' all-reduces) in the graph; the
  warm-up has built the communicator. Under data parallelism the stacked
  batches are this rank's columns of the super-batch
  (``parallel.stacked_batch_sharding``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List

import numpy as np
import torch


def _stack_metrics(per_step: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_multi_step(train_step: Callable) -> Callable:
    """Wrap ``train_step(state, batch) -> (state, metrics)`` so that
    ``multi_step(state, batches)`` takes a dict of tensors with a leading
    step axis ``(k, ...)`` and returns ``(state, metrics)`` with every
    metric stacked ``(k,)``."""
    graphs: Dict[tuple, Any] = {}

    mesh = getattr(train_step, "mesh", None)
    host_collectives = mesh is not None and mesh.ranks is not None and mesh.backend != "nccl"

    def multi_step(state, batches: Dict[str, torch.Tensor]):
        k = next(iter(batches.values())).shape[0]
        if next(iter(batches.values())).device.type != "cuda" or host_collectives:
            per_step = []
            for i in range(k):
                state, m = train_step(state, {name: v[i] for name, v in batches.items()})
                per_step.append(m)
            return state, _stack_metrics(per_step)
        # a graph binds the state's tensors: one per state and batch shape
        key = (id(state.optimizer),) + tuple(
            (name, tuple(v.shape[1:]), v.dtype) for name, v in sorted(batches.items()))
        per_step, first = [], 0
        if key not in graphs:
            graphs[key] = _capture(train_step, state, batches, per_step)
            first = 1
        graph, static, out = graphs[key]
        for i in range(first, k):
            for name, v in batches.items():
                static[name].copy_(v[i])
            graph.replay()
            state.step += 1
            per_step.append({name: t.clone() for name, t in out.items()})
        return state, _stack_metrics(per_step)

    return multi_step


def _capture(train_step: Callable, state, batches: Dict[str, torch.Tensor], per_step: list):
    """Run step 0 of ``batches`` eagerly on a side stream (the warm-up),
    then capture the step from static copies of its inputs. Appends step
    0's metrics to ``per_step``; returns (graph, static inputs, static
    metrics)."""
    if not state.capturable:
        raise ValueError("a CUDA multi-step needs a capturable train state: "
                         "create_train_state(..., capturable=True)")
    static = {name: v[0].clone() for name, v in batches.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        state, m = train_step(state, static)
        per_step.append({name: t.clone() for name, t in m.items()})
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    step = state.step  # the capture runs nothing: the host's count stays
    with torch.cuda.graph(graph):
        _, out = train_step(state, static)
    state.step = step
    return graph, static, out


def stack_host_batches(host_it: Iterator[Dict[str, Any]], k: int) -> Iterator[Dict[str, Any]]:
    """Group a host batch iterator into stacked ``(k, ...)`` super-batches
    (numpy, on the host: one upload feeds one ``multi_step``). A tail of
    fewer than k batches is dropped."""
    if k < 1:
        raise ValueError(f"steps per dispatch must be >= 1, got {k}")
    while True:
        group: List[Dict[str, Any]] = []
        for _ in range(k):
            try:
                group.append(next(host_it))
            except StopIteration:
                return
        yield {name: np.stack([b[name] for b in group]) for name in group[0]}


def clamp_steps_per_dispatch(k: int, *boundaries: int) -> int:
    """Largest divisor of every boundary (log and checkpoint cadence) that
    is <= k, so chunked stepping lands exactly on those edges; 1 when
    nothing larger divides them all."""
    k = max(1, int(k))
    for kk in range(k, 1, -1):
        if all(b % kk == 0 for b in boundaries if b):
            return kk
    return 1
