"""The benchmark's tracing: spans on the host clock and CUDA events, and a
profiler window read into device intervals.

``Spans`` keeps named durations in memory (seconds). ``profile_window``
runs a body under ``torch.profiler`` and reads the trace into a
``Trace``: every device operation (kernels, copies, fills) as a named
interval, the busy time (the union of those intervals inside the
window), and device time by kernel name; and, from one more window with
the host traced, the longest idle gaps with what the host thread was
doing in each. A window in which the profiler recorded no device
operation, or none of a family the cell's metrics read, is profiled
again; after ``tries`` windows the run fails rather than report a zero.
"""

from __future__ import annotations

import collections
import re
import statistics
import time

import torch

WINDOW = "portbench.window"


class Spans:
    def __init__(self):
        self.by_name = collections.defaultdict(list)

    def add(self, name: str, seconds: float) -> None:
        self.by_name[name].append(seconds)

    def median(self, name: str) -> float | None:
        v = self.by_name.get(name)
        return statistics.median(v) if v else None

    def host(self, name: str, fn):
        """``fn()`` timed on the host clock."""
        t = time.perf_counter()
        out = fn()
        self.add(name, time.perf_counter() - t)
        return out

    def events(self, name: str, fn, device):
        """``fn()`` timed by CUDA events around it on the current stream
        (the host clock after a synchronize off the card)."""
        if device.type != "cuda":
            return self.host(name, fn)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        self.add(name, a.elapsed_time(b) / 1e3)
        return out


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template arguments
    or parameters: ``void (anonymous namespace)::pconv_k1<128, 2>(...)`` ->
    ``pconv_k1``."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void ", "", s)
    depth, out = 0, []
    for ch in s:  # drop everything inside <...> and (...)
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    return s.split("::")[-1].split(" ")[-1] or name


class Trace:
    """Device intervals of one profiled window (seconds, relative)."""

    def __init__(self, device_ops: list, host_ops: list, window: tuple):
        self.window_s = window[1] - window[0]
        self.ops = [(short_name(n), s - window[0], e - window[0]) for n, s, e in device_ops
                    if e > window[0] and s < window[1]]
        self.host_ops = [(n, s - window[0], e - window[0]) for n, s, e in host_ops]
        busy, self.gaps, last = 0.0, [], 0.0
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, 0.0), min(e, self.window_s)
            if s > last:
                self.gaps.append((last, s))
            busy += max(0.0, e - max(s, last))
            last = max(last, e)
        if last < self.window_s:
            self.gaps.append((last, self.window_s))
        self.busy_s = busy
        self.gaps_named = []  # from a window with the host traced (profile_window)

    def has(self, prefix: str) -> bool:
        return any(n.startswith(prefix) for n, _, _ in self.ops)

    def time(self, prefixes) -> float:
        """Device seconds in operations whose short name starts with one of
        ``prefixes``."""
        return sum(e - s for n, s, e in self.ops if n.startswith(tuple(prefixes)))

    def top_ops(self, k: int = 10) -> list:
        tot = collections.Counter()
        for n, s, e in self.ops:
            tot[n] += e - s
        return [[n, t] for n, t in tot.most_common(k)]

    def top_gaps(self, k: int = 10) -> list:
        """The ``k`` longest idle gaps, each named by the innermost host
        range open on the window's thread at its middle."""
        out = []
        for a, b in sorted(self.gaps, key=lambda g: g[0] - g[1])[:k]:
            mid, best = (a + b) / 2, None
            for n, s, e in self.host_ops:
                if s <= mid <= e and (best is None or e - s < best[2] - best[1]):
                    best = (n, s, e)
            out.append([best[0] if best else "host: none", b - a])
        return out


def _is_range(e) -> bool:
    """A user range drawn on the device's timeline, not an operation."""
    if hasattr(e, "is_user_annotation"):
        return bool(e.is_user_annotation())
    return "annotation" in str(e.activity_type()).lower()


def _device_ops(prof) -> list:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not _is_range(e):
            s = e.start_ns() / 1e9
            out.append((e.name(), s, s + e.duration_ns() / 1e9))
    return out


def _host_ops(prof) -> list:
    """The ranges and operators open on the profiled window's thread."""
    evs = prof.profiler.kineto_results.events()
    win = [e for e in evs if e.name() == WINDOW]
    if not win:
        return []
    tid = win[0].start_thread_id()
    out = []
    for e in evs:
        if (e.device_type() != torch.autograd.DeviceType.CUDA and e.start_thread_id() == tid
                and e.name() not in (WINDOW, "Activity Buffer Request")):
            s = e.start_ns() / 1e9
            out.append((e.name(), s, s + e.duration_ns() / 1e9))
    return out


def _window(body, device, activities):
    """Profile ``body()`` under ``activities``; (profiler, (start, end) in
    seconds on the profiler's clock, the wall clock)."""
    from torch.profiler import profile, record_function

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        with record_function(WINDOW):
            body()
            if cuda:
                torch.cuda.synchronize(device)
        t1 = time.time_ns()
    return prof, (t0 / 1e9, t1 / 1e9)


def profile_window(body, device, families=(), tries: int = 5) -> Trace:
    """The device's operations while ``body()`` runs, read with the
    profiler on the device alone (its host-side tracing would slow a
    host-bound step and inflate the idle share), until a window records
    operations of every family in ``families``; a first window warms the
    profiler up and is dropped. One more window, with the host traced too,
    names the idle gaps (``Trace.top_gaps``) by what the host was doing."""
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    _window(body, device, acts)
    missing = list(families)
    for _ in range(tries):
        prof, (t0, t1) = _window(body, device, acts)
        ops = _device_ops(prof)
        if ops:  # the device's and the host's clocks agree to well under the window
            t0, t1 = min(t0, min(o[1] for o in ops)), max(t1, max(o[2] for o in ops))
        tr = Trace(ops, [], (t0, t1))
        missing = [f for f in families if not tr.has(f)]
        if (tr.ops or not cuda) and not missing:
            break
    else:
        raise RuntimeError(f"the profiler recorded no device operation of "
                           f"{missing or 'any kind'} in {tries} windows")
    prof, (t0, t1) = _window(body, device, [ProfilerActivity.CPU] + acts[:1] * cuda)
    named = Trace(_device_ops(prof), _host_ops(prof), (t0, t1))
    tr.gaps_named = named.top_gaps()
    return tr
