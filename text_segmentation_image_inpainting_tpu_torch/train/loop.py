"""The training CLIs' loop: resume, step, log, checkpoint.

Shared by ``run_inpaint`` and ``run_seg``, as the JAX CLIs share theirs
line for line: one record per ``log_every`` window through
``utils/logging.py::MetricLogger`` (``logs/<name>.jsonl`` and a line on
stderr) with the freshest step's metrics, held-out eval and training
pages/s (the first dispatch after a start or resume, which builds the
kernels and warms up, is not timed). With ``steps_per_dispatch`` k > 1
the steps run k at a time through ``train/multistep.py`` (a CUDA graph
on the card), ``--steps`` truncated to a multiple of k, as in JAX.

Started by ``torchrun`` with more than one process (``WORLD_SIZE`` > 1),
the CLIs train data-parallel over the global batch as JAX's do over all
devices (``run_data_parallel``): one rank per device, a rank mesh narrowed
to divide the batch (``parallel.make_mesh_for_batch``), every rank drawing
the same host batches and uploading its rows (``batch_sharding``, or
``stacked_batch_sharding`` with k steps per dispatch), the step over the
mesh (``train/accum.py``). Every rank restores the checkpoint; only rank 0
writes checkpoints and logs.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from text_segmentation_image_inpainting_tpu_torch.data.pipeline import to_device
from text_segmentation_image_inpainting_tpu_torch.models.base import save_model
from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh_for_batch,
    rank_device,
    shard_batch,
    stacked_batch_sharding,
)
from text_segmentation_image_inpainting_tpu_torch.train.checkpoint import CheckpointManager
from text_segmentation_image_inpainting_tpu_torch.train.multistep import (
    clamp_steps_per_dispatch,
    make_multi_step,
    stack_host_batches,
)
from text_segmentation_image_inpainting_tpu_torch.train.val import scored_eval
from text_segmentation_image_inpainting_tpu_torch.utils.logging import MetricLogger


def add_device_flag(parser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to train: the first CUDA device (default) or the CPU, "
                             "where every kernel runs its plain version")


def resolve_device(name: str) -> torch.device:
    """The device ``--device`` names: this rank's once the process group
    is up (``parallel.initialize_distributed``). CUDA that is not available
    is an error, never a silent fallback to the CPU."""
    ranked = rank_device()
    if ranked is not None:
        if (ranked.type == "cpu") != (name == "cpu"):
            raise SystemExit(f"--device {name}: this rank runs on {ranked}")
        return ranked
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False; pass "
                         "--device cpu to run on the CPU")
    return torch.device("cuda", 0)


def export(path: str | None, model) -> None:
    """``--export``: the final model's snapshot (``models/base.py``), by
    the writing rank."""
    if path and is_writer():
        save_model(path, model)
        print("exported model snapshot to", path)


def check_grad_accum(cfg) -> None:
    """JAX's CLI check: ``--grad-accum`` must divide ``--batch-size``."""
    if cfg.grad_accum < 1 or cfg.batch_size % cfg.grad_accum != 0:
        raise SystemExit(f"--grad-accum {cfg.grad_accum} must divide --batch-size "
                         f"{cfg.batch_size}")


def steps_per_dispatch(asked: int, cfg) -> int:
    """``--steps-per-dispatch`` clamped to divide ``--log-every`` and
    ``--ckpt-every``, with JAX's message when it moved."""
    spd = clamp_steps_per_dispatch(asked, cfg.log_every, cfg.checkpoint_every)
    if spd != asked:
        print(f"steps-per-dispatch clamped {asked} -> {spd} "
              "(must divide --log-every and --ckpt-every)")
    return spd


def run_data_parallel(device_flag: str, batch_size: int):
    """(device, mesh) of a CLI run: under ``torchrun`` with more than one
    process, this rank's device and the rank mesh over the ranks that
    divide ``batch_size`` ((None, None) on a rank outside it, which has
    nothing to train); otherwise ``--device``'s device and no mesh."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return resolve_device(device_flag), None
    if device_flag == "cuda" and not torch.cuda.is_available():
        resolve_device(device_flag)  # the same message as a single process
    device = initialize_distributed(platform=device_flag)
    mesh = make_mesh_for_batch(batch_size)
    if mesh.position() is None:
        print(f"rank {dist.get_rank()}: outside the {mesh.size}-way data-parallel mesh; idle")
        return None, None
    return device, mesh


def is_writer() -> bool:
    """Whether this process writes checkpoints and logs: rank 0 (or a
    single process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def train_loop(state, train_step, eval_step, make_batches, val_batches, cfg, *, steps: int,
               ckpt_dir: str, device, name: str, spd: int = 1, mesh=None):
    """Resume ``state`` from the latest checkpoint in ``ckpt_dir``, then
    run ``train_step`` up to ``steps`` updates on the batches of
    ``make_batches(start)``, the stream of training batches from page
    index ``start``, ``spd`` steps per dispatch. The stream is built after
    the restore, at the first page no finished step has seen (0 for a
    fresh start), so a resumed run trains on the same pages, in the same
    order, as one that never stopped. Logs as ``name``. Over a rank
    ``mesh`` each host batch is the global batch, of which this rank
    uploads its rows, and only rank 0 writes. Returns the state."""
    ckpt = CheckpointManager(ckpt_dir, save_interval_steps=cfg.checkpoint_every)
    state, restored_step = ckpt.restore_latest(state)
    if restored_step is not None:
        print(f"resumed from step {restored_step}")
    first_step = state.step
    if spd > 1 and first_step % spd != 0:
        # a hand-placed checkpoint off the k grid: keep the log and
        # checkpoint edges exact rather than drift them
        print(f"steps-per-dispatch disabled: resumed step {first_step} not a multiple of {spd}")
        spd = 1
    host_it = make_batches(first_step * cfg.batch_size)
    end_step = steps
    if spd > 1:
        host_it = stack_host_batches(host_it, spd)
        train_step = make_multi_step(train_step)
        end_step = first_step + max(0, steps - first_step) // spd * spd
        if end_step != steps:
            print(f"--steps truncated {steps} -> {end_step} (multiple of steps-per-dispatch)")
    writer = is_writer()
    logger = MetricLogger(name) if writer else None
    if mesh is None:
        place = lambda b: to_device(b, device)  # noqa: E731
    else:
        sharding = stacked_batch_sharding(mesh) if spd > 1 else batch_sharding(mesh)
        place = lambda b: shard_batch(  # noqa: E731
            mesh, {k: np.asarray(v, np.float32) for k, v in b.items()}, sharding)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.time()
    window_start = first_step
    for step in range(first_step, end_step, spd):
        batch = place(next(host_it))
        state, metrics = train_step(state, batch)
        done = step + spd
        if spd > 1:
            # metrics come back stacked (spd,); report the freshest step
            metrics = {k: v[-1] for k, v in metrics.items()}
        if step == first_step:
            sync()
            t0 = time.time()
            window_start = done
        if done % cfg.log_every == 0:
            sync()
            train_elapsed = time.time() - t0
            m = {k: float(v) for k, v in metrics.items()}
            if val_batches:
                m.update(scored_eval(eval_step, state, val_batches))
            else:
                # in-batch eval of the freshest step's batch
                last = {k: v[-1] for k, v in batch.items()} if spd > 1 else batch
                m.update(scored_eval(eval_step, state, [last], prefix=""))
            if done > window_start:
                m["pages_per_sec"] = (done - window_start) * cfg.batch_size / max(train_elapsed, 1e-9)
            if writer:
                logger.log(done, m)
            t0 = time.time()
            window_start = done
        if writer:
            ckpt.save(done, state)
    ckpt.wait()
    ckpt.close()
    if writer:
        logger.close()
    print("done:", state.step, "steps")
    return state
