"""The port's ``utils/logging.py`` and ``utils/profiling.py`` against the
JAX package's, on the CPU.

``MetricLogger`` writes the same JSONL records (keys and values; only
``time`` differs) and the same stderr line; ``checked`` raises where
JAX's checkify does on a non-finite output and stays quiet on a finite
one; ``timed`` returns a positive mean and the last result, as JAX's;
``trace`` leaves a trace file in its directory; ``sync`` returns its
argument.
"""

import json

import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_bridge import one_torch_thread
from text_segmentation_image_inpainting_tpu.utils import logging as jlogging
from text_segmentation_image_inpainting_tpu.utils import profiling as jprofiling
from text_segmentation_image_inpainting_tpu_torch.utils import logging as tlogging
from text_segmentation_image_inpainting_tpu_torch.utils import profiling as tprofiling


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
