"""step_dispatch_ms.train (ms; layer: training step, ``train/inpaint.py``,
``train/seg.py``, ``train/state.py``, ``train/accum.py``; moves
train_pages_per_s).

The host's hold per step: the median, over the traced run's window, of
the host-clock time until ``train_step(state, batch)`` returns, with no
synchronize (the runner's ``step_dispatch`` spans). A CUDA graph of the
step would shorten it."""

FAMILIES = ()


def read(ctx):
    v = ctx.spans.median("step_dispatch")
    return None if v is None else v * 1e3
