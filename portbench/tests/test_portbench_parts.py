"""``parts.py``'s attribution rule on a hand-built trace, the new readers
on it, and every reader that was there before reading the same with and
without a ``parts`` on the trace."""

import json
import types
from pathlib import Path

import pytest

from portbench import harness, parts
from portbench.trace import Spans, Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"seg_stage_device_ms.serve", "inpaint_stage_device_ms.serve", "bn_device_ms.serve",
       "serve_feed_wait_ms.serve", "serve_result_wait_ms.serve", "feed_starved_pct.serve",
       "bn_device_ms.train", "bn_device_ms.card_paced", "update_host_ms.train",
       "k3_roofline.train"}
MAIN, AUTOGRAD, WORKER = 1, 2, 3
NODE = parts.NODE + ": "


def host(name, corr, tid, start, end, fwd_tid=0, seq=-1):
    return parts.Event(name, False, corr, 0, tid, fwd_tid, seq, start, end)


def device(name, linked, start, end):
    return parts.Event(name, True, 0, linked, 0, 0, -1, start, end)


def step_events():
    """A forward with one BatchNorm, its backward on the autograd engine's
    thread (one BN node, one node under K3's span), a copy launched by
    another thread while the backward runs, and an update that started
    before the window (seconds; the window is (0, 100))."""
    return [
        # the caller's spans
        host("tsii.train.forward", 1, MAIN, 10.0, 20.0),
        host("tsii.bn", 2, MAIN, 11.0, 13.0),
        host("aten::batch_norm", 3, MAIN, 11.2, 12.8, seq=5),
        host("aten::native_batch_norm", 4, MAIN, 11.5, 12.5, seq=5),
        host("aten::mul", 5, MAIN, 14.0, 15.0, seq=6),
        host("tsii.train.backward", 6, MAIN, 30.0, 50.0),
        host("tsii.train.update", 7, MAIN, -5.0, -4.0),
        host("aten::add_", 8, MAIN, -4.8, -4.2),
        # the autograd engine's thread: BN's node, then the mul's under K3's span
        host(NODE + "NativeBatchNormBackward0", 20, AUTOGRAD, 31.0, 33.0, MAIN, 5),
        host("NativeBatchNormBackward0", 21, AUTOGRAD, 31.1, 32.9, MAIN, 5),
        host("aten::native_batch_norm_backward", 22, AUTOGRAD, 31.2, 32.8),
        host(NODE + "MulBackward0", 23, AUTOGRAD, 34.0, 35.0, MAIN, 6),
        host("MulBackward0", 24, AUTOGRAD, 34.05, 34.95, MAIN, 6),
        host("tsii.pconv.k3", 25, AUTOGRAD, 34.1, 34.9),
        host("aten::convolution_backward", 26, AUTOGRAD, 34.3, 34.7),
        # another thread (a feed's worker) copying while the backward runs
        host("aten::copy_", 31, WORKER, 31.1, 31.9),
        # the card
        device("bn_fwd_kernel", 4, 12.0, 12.5),
        device("mul_kernel", 5, 15.0, 15.125),
        device("bn_bwd_kernel", 22, 33.0, 33.5),
        device("dgrad_kernel", 26, 35.0, 35.25),
        device("Memcpy HtoD", 31, 32.0, 32.0625),
        device("add_kernel", 8, -4.0, -3.0),
        device("unlaunched_kernel", 0, 40.0, 41.0),
    ]


def test_parts_puts_each_operation_under_the_spans_of_its_launch():
    p = parts.from_events(step_events(), (0.0, 100.0))
    assert p.device_s["train.forward"] == pytest.approx(0.5 + 0.125)
    # the autograd thread's launches count under the caller's open span
    assert p.device_s["train.backward"] == pytest.approx(0.5 + 0.25)
    # BN's backward node is linked to bn by its forward op's sequence number
    assert p.device_s["bn"] == pytest.approx(0.5 + 0.5)
    assert p.device_s["pconv.k3"] == pytest.approx(0.25)
    # the other thread's copy counts toward no span, not the caller's backward
    assert set(p.device_s) == {"train.forward", "train.backward", "bn", "pconv.k3"}
    # a span that started before the window is not counted
    assert "train.update" not in p.device_s and p.count("train.update") == 0
    assert p.count("bn") == 1 and p.host_s["train.backward"] == [pytest.approx(20.0)]


def test_parts_links_a_node_only_to_its_own_forward_op():
    evs = [e._replace(seq=7) if e.name == "aten::batch_norm" else e for e in step_events()]
    # the composite before the node-taking op shares its number: the last
    # op to start with it is the node's
    evs.append(host("aten::view", 40, MAIN, 9.0, 9.5, seq=5))
    p = parts.from_events(evs, (0.0, 100.0))
    assert p.device_s["bn"] == pytest.approx(1.0)
    moved = [e._replace(seq=9) if e.name == "aten::native_batch_norm" else e for e in evs]
    assert parts.from_events(moved, (0.0, 100.0)).device_s["bn"] == pytest.approx(0.5)


class _Kineto:
    """An event of ``kineto_results.events()`` as torch 2.11 gives it (no
    ``activity_type``)."""

    def __init__(self, name, cuda, corr, linked, tid, start_ns, dur_ns, annotation=False):
        import torch

        self._f = dict(name=name, correlation_id=corr, linked_correlation_id=linked,
                       start_thread_id=tid, fwd_thread_id=0, sequence_nr=-1, start_ns=start_ns,
                       duration_ns=dur_ns, is_user_annotation=annotation,
                       device_type=torch.autograd.DeviceType.CUDA if cuda else
                       torch.autograd.DeviceType.CPU)

    def __getattr__(self, k):
        if k not in self._f:
            raise AttributeError(k)
        return lambda: self._f[k]


def test_events_leave_out_runtime_calls_and_markers():
    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [
                        _Kineto("tsii.bn", False, 7, 0, 1, 1000, 900, annotation=True),
                        _Kineto("aten::mul", False, 8, 0, 1, 1100, 500),
                        # the runtime's launch and CUPTI's marker carry ids of
                        # another count, here the same numbers as the ops'
                        _Kineto("cudaLaunchKernel", False, 7, 8, 1, 1200, 100),
                        _Kineto("cuLaunchKernelEx", False, 8, 8, 1, 1300, 100),
                        _Kineto("Command Buffer Full", False, 8, 0, 1, 1350, 10),
                        _Kineto("mul_kernel", True, 7, 8, 0, 2000, 250),
                        _Kineto("tsii.bn", True, 9, 0, 0, 2000, 250, annotation=True),
                    ]

    evs = parts.events(Prof())
    assert [(e.name, e.device) for e in evs] == [("tsii.bn", False), ("aten::mul", False),
                                                 ("mul_kernel", True)]
    p = parts.from_events(evs, (0.0, 1.0))
    assert p.device_s == {"bn": pytest.approx(250e-9)} and p.count("bn") == 1


class _Ctx:
    def __init__(self, cell, trace, units):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.window = {"serve_pages_per_s": 230.0, "train_pages_per_s": 120.0,
                       "interval_s": 0.035}
        self.spans, self.trace, self.units = Spans(), trace, units
        for n in ("closed_loop", "pipeline_run", "segmenter", "unet", "step_dispatch"):
            self.spans.add(n, 0.02)


def _trace():
    ops = [(n, s, s + 0.001) for s, n in enumerate(
        ["pconv_k2", "pconv_k1", "pconv_k1", "pconv_k2", "stem_dx_kernel", "stem_pool_kernel",
         "dw_wgrad_band", "pconv_k1", "pconv_k2", "elementwise_kernel"])]
    return Trace(ops, [], (0.0, 12.0))


def _hand_parts():
    return parts.Parts(
        {"pipeline.segment": 0.060, "pipeline.inpaint": 0.030, "bn": 0.024, "pconv.k3": 0.0096},
        {"pipeline.segment": [0.03] * 3, "pipeline.inpaint": [0.01] * 3,
         "serve.dispatch": [0.03] * 3, "serve.feed_wait": [0.001, 0.002, 0.004],
         "serve.result_wait": [0.02, 0.025, 0.03], "train.update": [0.004, 0.005, 0.006]},
        {"prefetch.batches": 12, "prefetch.starved": 3})


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_earlier_reader_reads_the_same_with_parts(cell):
    c = harness.load_cell(cell)
    earlier = [m["name"] for m in c.per_layer if m["name"] not in NEW]
    assert earlier
    tr = _trace()
    ctx = _Ctx(c, tr, 3)
    without = {n: harness.metric_module(n).read(ctx) for n in earlier}
    tr.parts = _hand_parts()
    with_parts = {n: harness.metric_module(n).read(ctx) for n in earlier}
    assert with_parts == without


def test_the_new_readers_read_the_parts():
    tr = _trace()
    tr.parts = _hand_parts()
    got = {}
    for cell in ("mnv2_pconv8.serve", "mnv2_pconv8.train_inpaint", "xception_pconv8.train_seg"):
        c = harness.load_cell(cell)
        ctx = _Ctx(c, tr, 3)
        for m in c.per_layer:
            if m["name"] in NEW:
                got[m["name"]] = harness.metric_module(m["name"]).read(ctx)
    assert got["seg_stage_device_ms.serve"] == pytest.approx(20.0)
    assert got["inpaint_stage_device_ms.serve"] == pytest.approx(10.0)
    assert got["bn_device_ms.serve"] == pytest.approx(8.0)
    assert got["serve_feed_wait_ms.serve"] == pytest.approx(2.0)
    assert got["serve_result_wait_ms.serve"] == pytest.approx(25.0)
    assert got["feed_starved_pct.serve"] == pytest.approx(25.0)
    assert got["update_host_ms.train"] == pytest.approx(5.0)
    assert got["bn_device_ms.train"] == got["bn_device_ms.card_paced"] == pytest.approx(8.0)
    # the 8 stride-1 layers' bound, 1.0886 ms a step, over 3.2 ms a step
    assert got["k3_roofline.train"] == pytest.approx(100.0 * 1.0885822 / 3.2, rel=1e-5)


def test_the_new_readers_read_nothing_without_the_programs_spans(monkeypatch):
    from text_segmentation_image_inpainting_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")  # a program that keeps no counters
    assert parts.program_counters() is None
    tr = _trace()
    tr.parts = parts.Parts({}, {}, None)
    for cell in ("mnv2_pconv8.serve", "mnv2_pconv8.train_inpaint", "xception_pconv8.train_seg"):
        c = harness.load_cell(cell)
        ctx = _Ctx(c, tr, 3)
        for m in c.per_layer:
            if m["name"] in NEW:
                assert harness.metric_module(m["name"]).read(ctx) is None, m["name"]


def test_a_profiled_window_is_read_through_trace(monkeypatch):
    """What a run goes through: ``profile_window`` (its ``_window`` wrapped
    by ``parts``), then ``parts.of`` on a Trace that carries no ``parts``."""
    import torch

    from portbench import trace
    from text_segmentation_image_inpainting_tpu_torch.utils.profiling import count, span

    monkeypatch.setattr(parts, "_LAST", {})

    def body():
        with span("serve.dispatch"):
            with span("bn"):
                torch.ones(64).add_(1)
        count("prefetch.batches", 4)
        count("prefetch.starved")

    ctx = types.SimpleNamespace(trace=trace.profile_window(body, torch.device("cpu")))
    p = parts.of(ctx)
    assert p.count("serve.dispatch") == 1 and p.count("bn") == 1
    assert p.host_s["bn"][0] <= p.host_s["serve.dispatch"][0]
    assert p.device_s == {}  # no device operation on the CPU
    # the counters' growth over the last window alone, not since the process started
    assert p.counts["prefetch.batches"] == 4 and p.counts["prefetch.starved"] == 1
    assert parts.of(ctx) is p  # the window is read once
    assert harness.metric_module("feed_starved_pct.serve").read(ctx) == pytest.approx(25.0)
    assert harness.metric_module("bn_device_ms.serve").read(ctx) is None


def test_a_window_that_cannot_be_read_raises(monkeypatch):
    monkeypatch.setattr(parts, "_LAST", {"prof": object(), "window": (0.0, 1.0), "counts": None})
    with pytest.raises(AttributeError):
        parts.of(types.SimpleNamespace(trace=_trace()))
