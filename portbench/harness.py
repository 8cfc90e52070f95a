"""One run of one cell of the port's benchmark, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds everything by those names:

  configs/<config>.json      the model's sizes (the entry's ``file``)
  traffic/<traffic>.json     the mix's parameters; its ``kind`` names
  mixes/<kind>.py            the general runner of that kind of mix
  metrics/<metric>.py        one reader per per-layer metric
  limits/<cell>.json         the limits of the numbers ``correct`` compares

An end-to-end metric named ``<quantity>.<group>`` reports the runner's
``<quantity>`` for the cells it lists, under a bound of its own: one
quantity whose cells spread unlike the others' is split so.

A run: set-up (the runner's), a check that nothing of JAX is loaded, the
window with the peak memory reset at its start, with ``--trace 1`` the
runner's span phases and a profiler window read by the metric files,
then the program's state is freed, the runner's judge runs the plain
reference, and the check runs again before anything is printed. The last
line on standard output is one JSON object; the numbers compared, each
with its limit, end standard error and the line (``checks``).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "text_segmentation_image_inpainting_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (the port's own name begins with the latter)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        boot = next(float(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        import os

        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(sorted(wl))})")
    w = wl[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer)


def mix_module(cell: Cell):
    return importlib.import_module(f"portbench.mixes.{cell.traffic['kind']}")


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Readings:
    """What a per-layer metric's reader reads: the cell, the window's
    numbers, the spans, the profiled window and how many units of work it
    held (None where the reader counts them from the trace)."""

    def __init__(self, cell, window, spans, trace, units):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.window, self.spans, self.trace, self.units = window, spans, trace, units


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, *, t0: float,
        fault: str | None = None) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    from portbench import judge
    from portbench.trace import profile_window

    cuda = device.type == "cuda"
    drv = mix_module(cell).Runner(cell, seed, device, fault=fault)
    drv.log = log
    drv.setup()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: loaded after set-up: {', '.join(found)}")
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t0
    win = drv.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    values = dict(win, setup_s=setup_s, peak_mem_gib=peak / 2**30)
    result = {"correct": False, "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": {}}
    if not trace:
        for m in cell.end_to_end:
            v = values[m["name"]] if m["name"] in values else values[m["name"].split(".")[0]]
            result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        drv.trace_phases()
        readers = {m["name"]: metric_module(m["name"]) for m in cell.per_layer}
        families = sorted({f for r in readers.values() for f in getattr(r, "FAMILIES", ())})
        body, units = drv.profile_body()
        tr = profile_window(body, device, families if cuda else ())
        drv.end_profile()
        ctx = Readings(cell, values, drv.spans, tr, units)
        for m in cell.per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.gaps_named}
        log(f"trace: {power_limit()}; profiled window {tr.window_s:.6f} s, device busy "
            f"{tr.busy_s:.6f} s")
    result["device"] = device_info
    drv.release()
    numbers = drv.judge()
    limits = judge.limits_for(cell.name)
    for k, v in numbers.items():
        if k not in limits:
            log(f"judge: {k}: {v!r} (not compared)")
    result["correct"], result["checks"] = judge.checks(numbers, limits)
    if result["failed"]:
        result["correct"] = False
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: loaded after the window: {', '.join(found)}")
    return result


def emit(result: dict) -> None:
    """The numbers compared on standard error's last lines, then the
    result as the last line of standard output, ``checks`` last in it."""
    checks = result.pop("checks", {})
    for name, (value, limit) in checks.items():
        log(f"check {name}: {value!r} (limit {limit!r})")
    result["checks"] = checks
    print(json.dumps(result, allow_nan=True), flush=True)


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = process_start() if t0 is None else t0
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"portbench: {cell.name} seed {args.seed} on {torch.cuda.get_device_name(device)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run(cell, args.seed, args.seconds, bool(args.trace), device, t0=t0)
    bad = [k for k, v in result["metrics"].items() if not math.isfinite(v["value"])]
    if bad:
        log(f"portbench: not finite: {', '.join(bad)}")
    emit(result)
    return 0
