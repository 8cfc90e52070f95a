"""Device and host time of the program's own spans in one profiled window.

The port names its layers with ``utils/profiling.py::span``: ranges named
``tsii.<name>`` in the profiler's trace, on the profiler's clock. ``read``
takes a window profiled with the host traced and puts every device
operation down to the spans open where it was launched:

* the operation is linked to the host op that launched it by the
  profiler's correlation id (``linked_correlation_id``), which gives the
  launching thread and a time inside the launch (the op's middle);
* it counts toward every ``tsii.`` span open on that thread at that time;
* the autograd engine's threads (those that run
  ``autograd::engine::evaluate_function`` nodes) open no program span but
  ``pconv.k3``: what they launch also counts toward the spans open at that
  time on the thread that called ``backward`` (the forward thread of the
  nodes they ran);
* an operation launched inside a backward node counts toward ``bn`` when
  the node's forward op, matched by sequence number and forward thread
  id, ran under ``bn`` (BatchNorm's backward glue).

A span's device time is the sum of its operations' durations, each once
however many instances of the span hold it; its host time is its own
duration. A span instance is counted when it starts inside the window.

``portbench/trace.py::profile_window`` keeps no profiler object, so this
module wraps ``trace._window`` when it is imported (a metric file imports
it before the window runs) and keeps the last window profiled with the host
traced, the one ``profile_window`` profiles last, with how much the
program's counters grew while it ran. ``of(ctx)`` reads it once; a
``parts`` attribute on the ``Trace`` takes precedence.
"""

from __future__ import annotations

import bisect
import collections
import re
import statistics
from typing import NamedTuple

from portbench import trace
from portbench.trace import _is_range

PREFIX = "tsii."
NODE = "autograd::engine::evaluate_function"
BN = "bn"


class Event(NamedTuple):
    """One event of the trace, in the fields ``read`` uses (seconds)."""

    name: str
    device: bool  # an operation on the card (kernel, copy, fill)
    corr: int  # a host op's correlation id (0 for a device operation)
    linked: int  # a device operation's launching host op (0 if none)
    tid: int  # a host op's thread
    fwd_tid: int  # a backward node's forward thread (0 otherwise)
    seq: int  # the autograd sequence number (-1 if none)
    start: float
    end: float


# host events that are not torch ops: CUDA API calls (cudaLaunchKernel,
# cuLaunchKernelEx...), which carry the device's correlation ids, and
# CUPTI's overhead markers
_NOT_OPS = re.compile(r"cu(da)?[A-Z]|(Activity Buffer Request|Buffer Flush|Command Buffer Full)$")


def _host_op(e) -> bool:
    """A torch op or a user range on the host, told apart by name from the
    API calls and CUPTI's markers (torch 2.11's events give no activity type)."""
    return not _NOT_OPS.match(e.name())


def events(prof) -> list:
    """The trace's host ops (torch ops and user ranges) and device
    operations as ``Event``s; runtime calls and device-side ranges left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e9
        end = s + e.duration_ns() / 1e9
        if e.device_type() == cuda:
            if not _is_range(e):
                out.append(Event(e.name(), True, 0, int(e.linked_correlation_id()), 0, 0, -1,
                                 s, end))
        elif _host_op(e):
            out.append(Event(e.name(), False, int(e.correlation_id()), 0,
                             int(e.start_thread_id()), int(e.fwd_thread_id()),
                             int(e.sequence_nr()), s, end))
    return out


class _Open:
    """Which intervals of one thread are open at a time: the sweep's
    boundaries and, after each, the open intervals' indices."""

    def __init__(self, intervals: list):
        marks = sorted([(s, 0, i) for i, (s, _) in enumerate(intervals)]
                       + [(e, 1, i) for i, (_, e) in enumerate(intervals)])
        self.times, self.open, now = [], [], set()
        for t, end, i in marks:
            (now.discard if end else now.add)(i)
            self.times.append(t)
            self.open.append(tuple(now))

    def at(self, t: float) -> tuple:
        k = bisect.bisect_right(self.times, t) - 1
        return self.open[k] if k >= 0 else ()


class Parts:
    """What one window's spans held: device seconds by span name, the host
    durations and the number of the instances that started inside it; and
    how much each of the program's counters grew over the window (None
    where the program keeps no counters)."""

    def __init__(self, device_s: dict, host_s: dict, counts: dict | None = None):
        self.device_s, self.host_s, self.counts = device_s, host_s, counts

    def count(self, name: str) -> int:
        return len(self.host_s.get(name, ()))


def from_events(evs: list, window: tuple) -> Parts:
    """``Parts`` of ``evs`` (``Event``s) by the module's rule."""
    t0, t1 = window
    host = [e for e in evs if not e.device]
    spans = collections.defaultdict(list)  # thread -> [(name, start, end)]
    nodes = collections.defaultdict(list)  # thread -> [(seq, fwd_tid, start, end)]
    by_corr, fwd_op = {}, {}
    callers = collections.defaultdict(collections.Counter)
    node_threads = set()
    for e in host:
        by_corr[e.corr] = e
        if e.name.startswith(PREFIX):
            spans[e.tid].append((e.name[len(PREFIX):], e.start, e.end))
        if e.name.startswith(NODE):
            node_threads.add(e.tid)
        if e.fwd_tid > 0 and e.seq >= 0:
            nodes[e.tid].append((e.seq, e.fwd_tid, e.start, e.end))
            if e.fwd_tid != e.tid:
                callers[e.tid][e.fwd_tid] += 1
        elif e.seq >= 0 and not e.name.startswith(NODE):
            # a forward op: the last one to start with a sequence number
            # is the one whose autograd node took it
            key = (e.tid, e.seq)
            if key not in fwd_op or e.start >= fwd_op[key][0]:
                fwd_op[key] = (e.start, (e.start + e.end) / 2)
    caller = {t: c.most_common(1)[0][0] for t, c in callers.items() if t in node_threads}
    open_spans = {t: _Open([(s, e) for _, s, e in v]) for t, v in spans.items()}
    open_nodes = {t: _Open([(s, e) for _, _, s, e in v]) for t, v in nodes.items()}

    def inside(t, at) -> list:
        """The span instances (thread, index) open on thread ``t`` at ``at``."""
        o = open_spans.get(t)
        return [(t, i) for i in o.at(at)] if o else []

    def in_window(t, i) -> bool:
        return t0 <= spans[t][i][1] <= t1

    device_s = collections.defaultdict(float)
    for d in evs:
        if not d.device or not d.linked or d.linked not in by_corr:
            continue
        op = by_corr[d.linked]
        at = (op.start + op.end) / 2
        held = inside(op.tid, at)
        if op.tid in caller:
            held += inside(caller[op.tid], at)
        names = {spans[t][i][0] for t, i in held if in_window(t, i)}
        if BN not in names and op.tid in open_nodes:
            inner = open_nodes[op.tid].at(at)
            if inner:
                seq, fwd, _, _ = nodes[op.tid][max(inner, key=lambda i: nodes[op.tid][i][2])]
                fo = fwd_op.get((fwd, seq))
                if fo and any(spans[fwd][i][0] == BN and in_window(fwd, i)
                              for _, i in inside(fwd, fo[1])):
                    names.add(BN)
        for n in names:
            device_s[n] += d.end - d.start
    host_s = collections.defaultdict(list)
    for v in spans.values():
        for n, s, e in v:
            if t0 <= s <= t1:
                host_s[n].append(e - s)
    return Parts(dict(device_s), dict(host_s))


def read(prof, window: tuple, counts: dict | None = None) -> Parts:
    """``Parts`` of a ``torch.profiler`` window (start, end in seconds on
    the profiler's clock) profiled with the host traced."""
    p = from_events(events(prof), window)
    p.counts = counts
    return p


def program_counters() -> dict | None:
    """The program's counters (``utils/profiling.py::counters``), or None
    where it keeps none."""
    try:
        from text_segmentation_image_inpainting_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()


# -- the window ``portbench/trace.py`` profiled last with the host traced ------
_LAST: dict = {}


def _keeping(window_fn):
    """``trace._window`` that also keeps a window profiled with the host
    traced, with the growth of the program's counters over it."""

    def window(body, device, activities):
        from torch.profiler import ProfilerActivity

        before = program_counters()
        prof, span = window_fn(body, device, activities)
        after = program_counters()
        _LAST.clear()
        if ProfilerActivity.CPU in activities:
            counts = None if after is None else {k: v - before.get(k, 0) for k, v in after.items()}
            _LAST.update(prof=prof, window=span, counts=counts)
        return prof, span

    return window


trace._window = _keeping(trace._window)


def of(ctx) -> Parts | None:
    """The ``Parts`` of the run's profiled window (read once), or None if
    none was kept. A window that cannot be read raises."""
    got = getattr(ctx.trace, "parts", None)
    if got is not None:
        return got
    if "parts" not in _LAST:
        if "prof" not in _LAST:
            return None
        _LAST["parts"] = read(_LAST.pop("prof"), _LAST["window"], _LAST["counts"])
    return _LAST["parts"]


def device_ms(ctx, name: str, per: str) -> float | None:
    """Device milliseconds under span ``name`` per instance of span ``per``
    (None where either is absent or no device operation ran under it)."""
    p = of(ctx)
    if p is None or not p.count(per) or not p.device_s.get(name):
        return None
    return p.device_s[name] / p.count(per) * 1e3


def host_median_ms(ctx, name: str) -> float | None:
    """The median host duration of span ``name``, in milliseconds."""
    p = of(ctx)
    v = p.host_s.get(name) if p is not None else None
    return statistics.median(v) * 1e3 if v else None
