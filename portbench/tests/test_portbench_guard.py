"""Nothing the benchmark runs loads JAX or the JAX package, the reference
imports nothing of the port, and nothing reads the JAX package's
benchmark (``bench/``, ``bench.py``, ``BENCH_*.json``)."""

import ast
import re
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
JAX_PKG = "text_segmentation_image_inpainting_tpu"
PORT = JAX_PKG + "_torch"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    return sorted((HERE.joinpath(*parts)).rglob("*.py"))


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("jax", "jaxlib.xla_client", "flax.linen", JAX_PKG + ".ops"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, name, object())
            assert harness.forbidden_modules() == [name.split(".")[0]]
    with monkeypatch.context() as m:
        for name in (PORT, PORT + ".ops", "jax_free", "flaxen"):
            m.setitem(sys.modules, name, object())
        assert harness.forbidden_modules() == []


def test_a_run_refuses_once_jax_is_loaded(monkeypatch):
    """The harness's own check, as ``run`` calls it after set-up."""
    import torch

    cell = harness.load_cell("mnv2_pconv8.train_seg")

    class Loads:
        def __init__(self, *a, **k):
            self.log = None

        def setup(self):
            sys.modules["jax"] = object()

    monkeypatch.setattr(harness, "mix_module", lambda c: type("m", (), {"Runner": Loads}))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        with pytest.raises(SystemExit, match="jax"):
            harness.run(cell, 1, 1.0, False, torch.device("cpu"), t0=0.0)
    finally:
        sys.modules.pop("jax", None)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", JAX_PKG}


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imports(path)
    assert PORT not in path.read_text()


def test_nothing_reads_the_jax_benchmark():
    for path in _sources():
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in (r"(?<!\w)bench\.py", r"BENCH_", r"(?<!\w)bench/", r"chip_smoke"):
            assert not re.search(word, text), (path, word)
