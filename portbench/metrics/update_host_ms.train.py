"""update_host_ms.train (ms; layer: training step, ``train/state.py``,
``train/inpaint.py``, ``train/seg.py``; moves train_pages_per_s).

The median host time of the program's span ``train.update`` (the clip,
Adam's step, the schedule; in seg, ``grad_norm`` too) in the window
profiled with the host traced, so with the CPU profiler's own cost in it."""

from portbench import parts

FAMILIES = ()


def read(ctx):
    return parts.host_median_ms(ctx, "train.update")
