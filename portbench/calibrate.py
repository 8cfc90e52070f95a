#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card, in
one process per cell:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds ... [--control bf16]] \
        [--faults half_batch,alter --fault-seeds ...] [--dtype float32] [--detail]

For each seed it makes the cell's set-up and (for a served cell) a short
window of ``--seconds`` at the cell's own load, frees the program and
prints the numbers ``correct`` compares: the program's against the f32
reference, the control's (the reference in the precision below the
configuration's, fp8, put in the program's place) and each planted
fault's.
``--control bf16`` puts the reference at the configuration's own precision
in the program's place instead: a witness of what that rounding alone
does to a number. ``--dtype`` runs the program in another compute dtype
(float32: with TF32 off, a witness of its arithmetic). ``--detail`` adds,
for a training cell, every leaf's norms on both sides.
The benchmark's own runs never run this. Each line is one JSON object;
the last one sums up: the largest reading of the sound runs per number,
and the smallest of the control and of each fault.
"""

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import harness
    from portbench.reference.precision import no_tf32

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--control", default="fp8")
    ap.add_argument("--dtype", default="")
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    if args.dtype:
        cell.config = dict(cell.config, compute_dtype=args.dtype)
    exact = no_tf32 if args.dtype == "float32" else contextlib.nullcontext
    train = cell.traffic["kind"] != "serve"
    ints = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    runs = [(s, None, None) for s in ints(args.seeds)]
    runs += [(s, None, args.control) for s in ints(args.control_seeds)]
    runs += [(s, f, None) for f in args.faults.split(",") if f for s in ints(args.fault_seeds)]
    summary = {}
    for seed, fault, control in runs:
        t = time.perf_counter()
        drv = harness.mix_module(cell).Runner(cell, seed, dev, fault=fault)
        with exact():
            drv.setup()
        if not train:
            drv.window(args.seconds)
        drv.release()
        numbers = (drv.judge(control=control, detail=True) if train and args.detail
                   else drv.judge(control=control))
        detail = numbers.pop("detail", None)
        del drv
        torch.cuda.empty_cache()
        who = control or fault or ("program" + (f"_{args.dtype}" if args.dtype else ""))
        line = {"workload": cell.name, "seed": seed, "who": who, "numbers": numbers,
                "seconds": time.perf_counter() - t}
        if detail is not None:
            line["detail"] = detail
        print(json.dumps(line), flush=True)
        agg = summary.setdefault(who, {})
        pick = max if who.startswith("program") else min
        for k, v in numbers.items():
            agg[k] = pick(agg.get(k, v), v)
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
