"""Two-stage (segment | inpaint) pipeline over a pair of devices, and the
two stages trained at once on two groups of ranks.

Counterpart of
``text_segmentation_image_inpainting_tpu/parallel/stage_pipeline.py``.
The segmenter runs on the stage mesh's first device and the U-Net on its
second, each on a CUDA stream of its own. At step t the host queues the
segmentation of microbatch t on stage 0 and the inpainting of
microbatch t - 1 on stage 1; the ``(pages | valid2d)`` payload of a
microbatch goes to stage 1 after an event recorded on stage 0's stream,
so both stages are busy after a one-step fill and the host never waits.
One card can hold both stages, ``make_stage_mesh(["cuda:0", "cuda:0"])``:
two streams on the same SMs.

The math is ``TextRemovalPipeline.run``'s, microbatch by microbatch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import torch

from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import (
    _available,
    _normalize,
    _world,
    entry_streams,
    make_rank_mesh,
    on_stream,
    replicate,
)
from text_segmentation_image_inpainting_tpu_torch.parallel.spatial import _to

STAGE_AXIS = "stage"


@dataclasses.dataclass(frozen=True)
class StageMesh:
    """Two devices along the ``stage`` axis: (segment, inpaint)."""

    devices: Tuple[torch.device, torch.device]
    axis_names: tuple = (STAGE_AXIS,)

    @property
    def shape(self) -> dict:
        return {STAGE_AXIS: 2}


def make_stage_mesh(devices: Sequence[Any] | None = None) -> StageMesh:
    """A 2-device stage mesh (seg | inpaint); a device may be named twice."""
    devices = _available(None) if devices is None else [_normalize(d) for d in devices]
    if len(devices) < 2:
        raise ValueError("stage pipelining needs 2 devices; one card may be named twice, "
                         "as ['cuda:0', 'cuda:0']")
    return StageMesh((devices[0], devices[1]))


@torch.no_grad()
def pipeline2_run(mesh: StageMesh, pipe, pages_mb: torch.Tensor) -> torch.Tensor:
    """Run T microbatches through the two-stage device pipeline.

    pages_mb: (T, N, H, W, 3) in [0, 1], H and W divisible by the U-Net's
    multiple. Returns (T, N, H, W, 3) composited clean pages in
    ``pipe.compute_dtype`` on stage 1's device, each microbatch equal to
    ``pipe.run``'s clean pages. ``pipe`` (in eval mode) is replicated to a
    stage's device where its parameters are not already there.
    """
    t_mb, _, h, w, _ = pages_mb.shape
    size = 1 << pipe.unet.depth
    if h % size or w % size:
        raise ValueError(f"pages {h}x{w} must be multiples of 2**depth={size}")
    d0, d1 = mesh.devices
    stage0, stage1 = replicate(pipe, d0), replicate(pipe, d1)
    dt = pipe.compute_dtype
    s0, s1 = entry_streams((d0, d1))
    ready = None
    if pages_mb.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(pages_mb.device))
    outs = []
    prev = None  # (payload, event) of the microbatch stage 1 takes next
    for t in range(t_mb + 1):
        cur = None
        if t < t_mb:
            with on_stream(d0, s0):
                if ready is not None and t == 0:
                    s0.wait_event(ready)
                p = _to(pages_mb[t], d0).to(dt)
                valid2d = stage0._segment2d(p)
                payload = torch.cat([p, valid2d[..., None]], dim=-1)
                done = None
                if s0 is not None:
                    done = torch.cuda.Event()
                    done.record(s0)
                cur = (payload, done)
        if prev is not None:
            with on_stream(d1, s1):
                payload, done = prev
                if done is not None:
                    s1.wait_event(done)
                pl = _to(payload, d1)
                outs.append(stage1._inpaint2d(pl[..., :3], pl[..., 3]))
        prev = cur
    with on_stream(d1, s1):
        out = torch.stack(outs)
        done = None
        if s1 is not None:
            done = torch.cuda.Event()
            done.record(s1)
    if done is not None:
        caller = torch.cuda.current_stream(d1)
        caller.wait_event(done)
        out.record_stream(caller)
    return out


def pipeline2_throughput_model(t_seg: float, t_inpaint: float, t_mb: int) -> Tuple[float, float]:
    """(fused single device, 2-stage pipelined) seconds for T microbatches:
    the analytical model the schedule targets, fill + slowest-stage bound."""
    fused = t_mb * (t_seg + t_inpaint)
    piped = (t_seg + t_inpaint) + (t_mb - 1) * max(t_seg, t_inpaint)
    return fused, piped


# The two stages train independently (separate data, losses and models):
# no gradient crosses the stage boundary, so the training analogue of the
# stage pipeline is concurrency. ``make_group_meshes`` splits the ranks
# into two disjoint groups, one per stage, and ``concurrent_train2`` runs
# on each rank the step of its own group: the groups share no state and
# no rank, and neither waits on the other. As in JAX, data parallelism of
# each stage over every rank, one stage after the other, is the default
# the CLIs take; this is the composition helper.


def make_group_meshes(ranks: Sequence[int] | None = None, *, seg_fraction: float = 0.5):
    """Split the ranks (all of the world by default) into two disjoint
    rank meshes (seg, inpaint): the first round(n * seg_fraction) ranks,
    at least one and at most n - 1, train the segmenter. Every rank of the
    world must call it (each group is a ``new_group``)."""
    ranks = list(range(_world())) if ranks is None else [int(r) for r in ranks]
    if len(ranks) < 2:
        raise ValueError("2-group training needs 2+ ranks")
    k = max(1, min(len(ranks) - 1, int(round(len(ranks) * seg_fraction))))
    return make_rank_mesh(ranks[:k]), make_rank_mesh(ranks[k:])


def _mine(step) -> bool:
    mesh = getattr(step, "mesh", None)
    return mesh is None or mesh.ranks is None or mesh.position() is not None


def concurrent_train2(seg_step, inpaint_step):
    """Compose the two stages' train steps, each made over its group's
    mesh (``make_seg_train_step(..., mesh=seg_mesh)``), into
    ``step(seg_state, seg_batch, inp_state, inp_batch) -> (seg_state,
    seg_metrics, inp_state, inp_metrics)``. A rank runs the step of the
    group it belongs to; the other stage's state and batch (None there)
    come back as they were, with metrics None. Steps made without a rank
    mesh both run, one after the other. The math is each step's run alone."""

    def step(seg_state, seg_batch, inp_state, inp_batch):
        seg_metrics = inp_metrics = None
        if _mine(seg_step):
            seg_state, seg_metrics = seg_step(seg_state, seg_batch)
        if _mine(inpaint_step):
            inp_state, inp_metrics = inpaint_step(inp_state, inp_batch)
        return seg_state, seg_metrics, inp_state, inp_metrics

    return step
