"""Profiling and debugging helpers.

Counterpart of ``text_segmentation_image_inpainting_tpu/utils/profiling.py``:

* ``trace(log_dir)``: ``torch.profiler`` over the block, CPU and CUDA
  activity, its trace written into ``log_dir`` (TensorBoard's format);
* ``sync(tree)``: wait until the first tensor of a result is computed;
* ``timed(fn, ...)``: mean seconds per call and the last result, with
  CUDA events when the result lies on the card, else the host's clock;
* ``enable_nan_debugging()``: autograd's anomaly mode;
* ``checked(fn)``: ``(err, out)`` with ``err.throw()`` raising if any
  floating tensor of ``out`` holds a NaN or an infinity.

torch has neither JAX's ``checkify`` nor a forward ``debug_nans``. So
``checked`` looks at the function's outputs only, after it ran (JAX also
catches a NaN inside the function, a division by zero and an index out
of bounds), and anomaly mode raises where a backward produces a NaN, not
a forward (a difference by design, ROADMAP Queue 3).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@contextlib.contextmanager
def trace(log_dir: str = "logs/profile"):
    """``with trace(): run_step()``: a trace of the block in ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def sync(tree):
    """Wait for the first tensor of ``tree`` (a stream's work completes in
    order, so the rest of one call's results are done too)."""
    for x in _tensors(tree):
        if x.is_cuda:
            torch.cuda.current_stream(x.device).synchronize()
        break
    return tree


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1, **kwargs):
    """(mean seconds per call, last result): CUDA events around the
    ``iters`` calls when the warm-up's result is on the card, else the
    host's clock with a wait after each call."""
    out = None
    for _ in range(warmup):
        out = sync(fn(*args, **kwargs))
    if any(x.is_cuda for x in _tensors(out)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = sync(fn(*args, **kwargs))
    return (time.perf_counter() - t0) / iters, out


def enable_nan_debugging(enable: bool = True) -> None:
    """Autograd's anomaly mode: a backward that makes a NaN raises, with
    the forward op that made its input."""
    torch.autograd.set_detect_anomaly(enable)


class _Error:
    def __init__(self, bad):
        self.bad = bad

    def throw(self) -> None:
        if self.bad:
            raise FloatingPointError("; ".join(self.bad))


def checked(fn: Callable):
    """``err, out = checked(fn)(...); err.throw()``: raises if a floating
    output of ``fn`` holds a NaN or an infinity (one host read per call)."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        floats = [x for x in _tensors(out) if x.is_floating_point()]
        flags = [bool(v) for v in torch.stack([~torch.isfinite(x).all() for x in floats]).cpu()] \
            if floats else []
        bad = [f"output {i} {tuple(x.shape)} holds a NaN or an infinity"
               for i, (x, f) in enumerate(zip(floats, flags)) if f]
        return _Error(bad), out

    return wrapped
