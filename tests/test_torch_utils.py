"""The port's ``utils/logging.py`` and ``utils/profiling.py`` against the
JAX package's, on the CPU.

``MetricLogger`` writes the same JSONL records (keys and values; only
``time`` differs) and the same stderr line; ``checked`` raises where
JAX's checkify does on a non-finite output and stays quiet on a finite
one; ``timed`` returns a positive mean and the last result, as JAX's;
``trace`` leaves a trace file in its directory; ``sync`` returns its
argument. The port's own spans and counters (no JAX counterpart): ``span``
is one shared no-op with no profiler and a ``tsii.`` range under one,
``count`` adds up from several threads, the server counts its prefetched
batches and opens its spans, and a seg train step opens its four phases
and one ``bn`` per BatchNorm call.
"""

import json
import threading

import numpy as np

import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_bridge import one_torch_thread
from text_segmentation_image_inpainting_tpu.utils import logging as jlogging
from text_segmentation_image_inpainting_tpu.utils import profiling as jprofiling
from text_segmentation_image_inpainting_tpu_torch.utils import logging as tlogging
from text_segmentation_image_inpainting_tpu_torch.utils import profiling as tprofiling

from torch.profiler import ProfilerActivity, profile


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def test_metric_logger_writes_jax_records(tmp_path, capsys):
    metrics = {"total": 1.25, "val_iou": 0.5, "pages_per_sec": 12.0}
    for mod, name in ((jlogging, "jax"), (tlogging, "port")):
        logger = mod.MetricLogger("seg", log_dir=str(tmp_path / name))
        logger.log(3, {k: (jnp.float32(v) if name == "jax" else torch.tensor(v))
                       for k, v in metrics.items()})
        logger.log(4, metrics)
        logger.close()
    err = capsys.readouterr().err.splitlines()
    assert err[:2] == err[2:] == ["[seg] step=3 total=1.25 val_iou=0.5 pages_per_sec=12",
                                  "[seg] step=4 total=1.25 val_iou=0.5 pages_per_sec=12"]
    rows = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "seg.jsonl") as f:
            rows[name] = [json.loads(line) for line in f]
    for a, b in zip(rows["jax"], rows["port"]):
        assert list(a) == list(b)
        a.pop("time"), b.pop("time")
        assert a == b


def test_checked_raises_on_non_finite_outputs_as_jax():
    def bad_t():
        return torch.tensor([1.0, 0.0]) / torch.tensor([1.0, 0.0])

    def bad_j(x):
        return x / x

    err, out = tprofiling.checked(bad_t)()
    assert torch.isnan(out[1])
    with pytest.raises(FloatingPointError, match="NaN"):
        err.throw()
    jerr, _ = jprofiling.checked(bad_j)(jnp.asarray([1.0, 0.0]))
    with pytest.raises(Exception):
        jerr.throw()
    ok, out = tprofiling.checked(lambda: {"a": torch.ones(2), "n": torch.arange(3)})()
    ok.throw()
    assert torch.equal(out["a"], torch.ones(2))


def test_timed_sync_and_trace(tmp_path):
    x = torch.ones(4)
    secs, out = tprofiling.timed(lambda a: a * 2, x, iters=3, warmup=1)
    jsecs, jout = jprofiling.timed(lambda a: a * 2, jnp.ones(4), iters=3, warmup=1)
    assert secs > 0 and jsecs > 0
    assert out.tolist() == jout.tolist() == [2.0] * 4
    tree = {"a": x, "b": [x]}
    assert tprofiling.sync(tree) is tree
    with tprofiling.trace(str(tmp_path / "trace")):
        (x + 1).sum()
    assert any(p.is_file() for p in (tmp_path / "trace").rglob("*"))


def test_nan_debugging_is_anomaly_mode():
    tprofiling.enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        tprofiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def _spans(prof) -> list:
    """(name, start, end, thread) of every ``tsii.`` range, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("tsii.")]
    return sorted(out, key=lambda r: r[1])


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_is_one_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = tprofiling.span("serve.dispatch"), tprofiling.span("bn")
    assert a is b
    with a as entered:
        assert entered is a
    with _cpu_profile():
        assert tprofiling.span("bn") is not a
    assert tprofiling.span("bn") is a


def test_spans_nest_under_a_profiler():
    with _cpu_profile() as prof:
        with tprofiling.span("outer"):
            with tprofiling.span("inner"):
                torch.ones(8).add_(1.0)
            with tprofiling.span("inner"):
                torch.ones(8).mul_(2.0)
    got = _spans(prof)
    assert [n for n, *_ in got] == ["tsii.outer", "tsii.inner", "tsii.inner"]
    (_, s0, e0, t0), (_, s1, e1, t1), (_, s2, e2, t2) = got
    assert t0 == t1 == t2
    assert s0 <= s1 <= e1 <= s2 <= e2 <= e0


def test_counters_add_up_from_two_threads():
    before = tprofiling.counters().get("test.threads", 0)

    def work():
        for _ in range(5000):
            tprofiling.count("test.threads")
        tprofiling.count("test.threads", 7)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = tprofiling.counters()
    assert got["test.threads"] - before == 2 * 5007
    got["test.threads"] = -1  # a copy: the table itself is untouched
    assert tprofiling.counters()["test.threads"] - before == 2 * 5007


def test_the_server_counts_its_batches_and_opens_its_spans():
    from text_segmentation_image_inpainting_tpu_torch.models.partial_convolution import (
        InpaintUNet,
    )
    from text_segmentation_image_inpainting_tpu_torch.models.text_segmentation import (
        TextSegmenter,
    )
    from text_segmentation_image_inpainting_tpu_torch.pipeline.end_to_end import (
        TextRemovalPipeline,
    )
    from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import PageStreamServer

    pipe = TextRemovalPipeline(
        TextSegmenter(width_mult=0.35, dtype=torch.float32), InpaintUNet(depth=3),
        compute_dtype=torch.float32, dilate_radius=1,
    ).init_weights(torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8) for _ in range(3)]
    before = tprofiling.counters()
    with _cpu_profile() as prof:
        out = list(PageStreamServer(pipe, depth=1).serve(iter(batches)))
    after = tprofiling.counters()
    assert len(out) == 3
    assert after["prefetch.batches"] - before.get("prefetch.batches", 0) == 3
    starved = after.get("prefetch.starved", 0) - before.get("prefetch.starved", 0)
    assert 0 <= starved <= 3
    names = [n for n, *_ in _spans(prof)]
    for name, n in (("serve.feed_wait", 4), ("serve.dispatch", 3), ("serve.result_wait", 3),
                    ("pipeline.segment", 3), ("pipeline.inpaint", 3)):
        assert names.count("tsii." + name) == n, name
    dispatch = [(s, e) for n, s, e, _ in _spans(prof) if n == "tsii.serve.dispatch"]
    segment = [s for n, s, e, _ in _spans(prof) if n == "tsii.pipeline.segment"]
    assert all(any(a <= s <= b for a, b in dispatch) for s in segment)


def test_a_seg_step_opens_its_phases_and_one_bn_per_batchnorm():
    from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import BatchNorm
    from text_segmentation_image_inpainting_tpu_torch.models.text_segmentation import (
        TextSegmenter,
    )
    from text_segmentation_image_inpainting_tpu_torch.train.config import (
        OptimizerConfig,
        SegTrainConfig,
    )
    from text_segmentation_image_inpainting_tpu_torch.train.seg import make_seg_train_step
    from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

    torch.manual_seed(0)
    model = TextSegmenter(width_mult=0.35, dtype=torch.float32)
    cfg = SegTrainConfig(image_size=(32, 32), batch_size=2,
                         optimizer=OptimizerConfig(kind="adam", learning_rate=1e-3))
    step = make_seg_train_step(model, cfg)
    state = create_train_state(model, cfg.optimizer)
    calls = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(lambda mod, args: calls.append(mod))
    batch = {"image": torch.rand(2, 32, 32, 3),
             "mask": (torch.rand(2, 32, 32, 1) > 0.5).float()}
    with _cpu_profile() as prof:
        state, metrics = step(state, batch)
    got = _spans(prof)
    names = [n for n, *_ in got]
    for phase in ("forward", "loss", "backward", "update"):
        assert names.count(f"tsii.train.{phase}") == 1, phase
    assert calls and names.count("tsii.bn") == len(calls)
    (fs, fe), = [(s, e) for n, s, e, _ in got if n == "tsii.train.forward"]
    assert all(fs <= s <= e <= fe for n, s, e, _ in got if n == "tsii.bn")
    order = [n for n in names if n.startswith("tsii.train.")]
    assert order == ["tsii.train.forward", "tsii.train.loss", "tsii.train.backward",
                     "tsii.train.update"]
    assert torch.isfinite(metrics["grad_norm"])
