"""The training CLIs' loop: resume, step, log, checkpoint.

Shared by ``run_inpaint`` and ``run_seg``, as the JAX CLIs share theirs
line for line: one JSON line per ``log_every`` window with the step's
metrics, held-out eval and training pages/s (the first step after a
start or resume, which builds the kernels and warms up, is not timed).
"""

from __future__ import annotations

import json
import time

import torch

from text_segmentation_image_inpainting_tpu_torch.data.pipeline import to_device
from text_segmentation_image_inpainting_tpu_torch.models.base import save_model
from text_segmentation_image_inpainting_tpu_torch.train.checkpoint import CheckpointManager
from text_segmentation_image_inpainting_tpu_torch.train.val import scored_eval


def add_device_flag(parser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to train: the first CUDA device (default) or the CPU, "
                             "where every kernel runs its plain version")


def resolve_device(name: str) -> torch.device:
    """The device ``--device`` names. CUDA that is not available is an
    error, never a silent fallback to the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False; pass "
                         "--device cpu to run on the CPU")
    return torch.device("cuda", 0)


def export(path: str | None, model) -> None:
    """``--export``: the final model's snapshot (``models/base.py``)."""
    if path:
        save_model(path, model)
        print("exported model snapshot to", path)


def train_loop(state, train_step, eval_step, make_batches, val_batches, cfg, *, steps: int,
               ckpt_dir: str, device):
    """Resume ``state`` from the latest checkpoint in ``ckpt_dir``, then
    run ``train_step`` up to ``steps`` updates on the batches of
    ``make_batches(start)``, the stream of training batches from page
    index ``start``. The stream is built after the restore, at the first
    page no finished step has seen (0 for a fresh start), so a resumed run
    trains on the same pages, in the same order, as one that never
    stopped. Returns the state."""
    ckpt = CheckpointManager(ckpt_dir, save_interval_steps=cfg.checkpoint_every)
    state, restored_step = ckpt.restore_latest(state)
    if restored_step is not None:
        print(f"resumed from step {restored_step}")
    first_step = state.step
    host_it = make_batches(first_step * cfg.batch_size)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.time()
    window_start = first_step
    for step in range(first_step, steps):
        batch = to_device(next(host_it), device)
        state, metrics = train_step(state, batch)
        done = step + 1
        if step == first_step:
            sync()
            t0 = time.time()
            window_start = done
        if done % cfg.log_every == 0:
            sync()
            train_elapsed = time.time() - t0
            m = {k: float(v) for k, v in metrics.items()}
            m.update(scored_eval(eval_step, state, val_batches) if val_batches
                     else scored_eval(eval_step, state, [batch], prefix=""))
            if done > window_start:
                m["pages_per_sec"] = (done - window_start) * cfg.batch_size / max(train_elapsed, 1e-9)
            print(json.dumps({"step": done, **m}), flush=True)
            t0 = time.time()
            window_start = done
        ckpt.save(done, state)
    ckpt.wait()
    ckpt.close()
    print("done:", state.step, "steps")
    return state
