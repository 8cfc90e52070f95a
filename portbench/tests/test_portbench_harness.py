"""The harness as data: every cell resolves its files by name,
``BENCHMARK.json`` keeps the contract's shape, and each mix runs through
the harness's own functions at a CPU test's size (no look for a card),
emitting the contract's line, and comes out incorrect when its timed
path is broken underneath."""

import json
import re
from pathlib import Path

import pytest
import torch

from portbench import harness, judge

from .conftest import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_the_file_has_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p and p[0] != "/"
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert (ROOT / c["file"]).is_file() and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
        assert m["source"] in SOURCES and set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for cell in m.get("workloads", CELLS):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", CELLS)
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        c = harness.load_cell(cell)
        got = {m["name"] for m in c.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_its_files_by_name(cell):
    c = harness.load_cell(cell)
    drv = harness.mix_module(c)
    assert hasattr(drv, "Runner")
    for m in c.per_layer:
        assert callable(harness.metric_module(m["name"]).read)
    assert set(judge.limits_for(cell)) <= _number_names(c)


def _number_names(c):
    if c.traffic["kind"] == "serve":
        return {"mask_margin", "mask_flip_pct", "clean_hole_mae", "clean_valid_max"}
    return {f"{w}{m}_gap" for w in ("loss", "grad", "change", "stats", "stats1", "stats1_var")
            for m in ("", "_median")} - {"loss_median_gap"} | {"loss1_gap"}


def _run(cell, fault=None, trace=False):
    c = tiny(harness.load_cell(cell))
    return harness.run(c, 987654321987, 0.5, trace, torch.device("cpu"), t0=0.0, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_emits_the_contracts_line(cell, capsys):
    for trace in (False, True):
        harness.emit(_run(cell, trace=trace))
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert list(line)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
        assert line["attempted"] > 0 and line["failed"] == 0
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        names = {m["name"] for m in harness.load_cell(cell).end_to_end}
        if not trace:
            assert set(line["metrics"]) == names
        else:
            assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
            assert not set(line["metrics"]) & names
        for name, (value, limit) in line["checks"].items():
            assert isinstance(value, float) and isinstance(limit, (int, float))


FAULTS = {"serve": ("half_batch", "alter"), "train": ("frozen_state", "half_batch", "alter")}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[
    harness.load_cell(c).traffic["kind"]]])
def test_a_broken_path_comes_out_incorrect(cell, fault):
    sound, broken = _run(cell)["checks"], _run(cell, fault)
    assert broken["correct"] is False
    caught = [k for k, (v, lim) in broken["checks"].items()
              if v > lim and v > 3 * sound[k][0]]
    assert caught, (sound, broken["checks"])
