#!/usr/bin/env python3
"""K6's general form under every cut near its plan's, on one NVIDIA GPU.

At each shape, in bf16 and f32: the plan's cut (``k6_gen_plan``), a fixed
rule's cut (``rule_cut``: the widest tiles, all tap rows a group where the
shared memory fits, whole rows, bands of at most 32 rows cut only to fill
the SMs) and the same call under forced cuts (tiles of tap columns, tap
rows a group, band rows, strip width: every combination that fits the
shared memory; strips of the whole row, half of it, the plan's and the
rule's), each launched through ``_launch_k6_gen`` and timed as a
CUDA-event median; the five fastest, and the plan's and the rule's time
over the fastest of all. The last lines give the geometric mean and the
largest of those two ratios, over the fitted shapes and the held-out ones.

``SHAPES`` (k 9 on the segmenter's block-2 map, ``chip_smoke.py``'s
SCOPE_K6 shapes, three near the templated form's limits) are the ones the
plan's cost model (``GEN_COST`` in ``ops/kernels/depthwise_wgrad.py``) was
fitted to; ``HELD_OUT`` are shapes it never saw.

    python3 tools/k6_gen_cuts.py [--quick | --held-out | --all]

``--quick``: block 2's map only; ``--held-out``: ``HELD_OUT`` only;
``--all``: both sets.
"""

from __future__ import annotations

import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (N, H, W, C, k, d)
SHAPES = ((8, 128, 128, 144, 9, 1), (2, 64, 64, 128, 9, 1), (2, 96, 96, 128, 7, 48),
          (2, 64, 64, 130, 13, 2), (8, 64, 64, 192, 7, 10), (8, 128, 128, 144, 3, 27),
          (8, 128, 128, 144, 7, 9), (8, 128, 128, 144, 5, 10))
HELD_OUT = ((4, 96, 160, 256, 11, 1), (8, 64, 64, 192, 9, 2), (2, 128, 128, 130, 15, 3),
            (4, 200, 120, 144, 5, 16), (16, 32, 32, 384, 13, 1), (1, 512, 512, 128, 9, 4),
            (8, 128, 128, 144, 3, 30), (2, 48, 80, 200, 31, 1))


def event_ms(fn, iters: int = 8, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def forced_cut(kdw, base, n, h, w, k, d, elem, tj, kg, rows, tw):
    """``base`` (the plan's K6GenPlan at these shapes) with its cut replaced:
    tiles of ``tj`` columns, all of a row's tiles a group, ``kg`` tap rows a
    group, bands of ``rows``, strips of ``tw``."""
    ntj = cdiv(base.kc, tj)
    slots = n * cdiv(h, rows) * cdiv(w, tw)
    return base._replace(tj=tj, ntj=ntj, ntg=ntj, kg=kg, rows=rows, bands=cdiv(h, rows), tw=tw,
                         strips=cdiv(w, tw), fold=kdw._gen_fold(slots),
                         smem=kdw.k6_gen_smem(h, w, k, d, tj, ntj, kg, tw, elem), chain=0)


def rule_cut(kdw, base, n, h, w, c, k, d, elem, sms):
    """The fixed rule: tiles as wide as GEN_TJ allows, all of a row a group;
    the whole row a strip (else the widest strip that fits); as many tap
    rows a group as the shared memory and 64 items allow; then the most
    band rows of (32, 24, 16, 8) that still give two CTAs an SM."""
    ntj = cdiv(base.kc, kdw.K6_GEN_TJ)
    tj = cdiv(base.kc, ntj)
    krn = 2 * base.kri + 1
    tw = next(t for t in kdw._strip_widths(w)
              if kdw.k6_gen_smem(h, w, k, d, tj, ntj, 1, t, elem) <= kdw.SMEM_LIMIT)
    kg = next(g for g in range(min(krn, kdw.K6_GEN_NPX // ntj), 0, -1)
              if kdw.k6_gen_smem(h, w, k, d, tj, ntj, g, tw, elem) <= kdw.SMEM_LIMIT)
    ctas = n * cdiv(w, tw) * cdiv(c, kdw.K6_GEN_CH) * cdiv(krn, kg)
    rows = next((r for r in (32, 24, 16) if r <= h and ctas * cdiv(h, r) >= 2 * sms), min(8, h))
    return forced_cut(kdw, base, n, h, w, k, d, elem, tj, kg, rows, tw)


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_gen_cuts: no CUDA device", file=sys.stderr)
        return 2
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"k6_gen_cuts: {smi}; torch {torch.__version__}", flush=True)
    sms = kdw._sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(7)
    args = sys.argv[1:]
    shapes = (SHAPES[:1] if "--quick" in args else HELD_OUT if "--held-out" in args
              else SHAPES + HELD_OUT if "--all" in args else SHAPES)
    ratios = []
    for n, h, w, c, k, d in shapes:
        for dt in (torch.bfloat16, torch.float32):
            elem = 2 if dt == torch.bfloat16 else 4
            x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
            dy = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
            g = kdw.k6_gen_plan(n, h, w, c, k, d, elem, sms)
            r = rule_cut(kdw, g, n, h, w, c, k, d, elem, sms)
            shape = f"{(n, h, w, c)} k {k} d {d} {'bf16' if elem == 2 else 'f32'}"
            t_plan = event_ms(lambda: kdw._launch_k6_gen(x, dy, k, d, g))
            t_rule = event_ms(lambda: kdw._launch_k6_gen(x, dy, k, d, r))
            print(f"{shape}: the plan's cut {g}: {t_plan:.4f} ms; the rule's cut (tj {r.tj}, "
                  f"kg {r.kg}, rows {r.rows}, tw {r.tw}): {t_rule:.4f} ms", flush=True)
            krn = 2 * g.kri + 1
            tjs = sorted({cdiv(g.kc, nt) for nt in range(cdiv(g.kc, kdw.K6_GEN_TJ), g.kc + 1)},
                         reverse=True)[:3]
            res = []
            for tj in tjs:
                ntg = cdiv(g.kc, tj)
                for kg in sorted({1, 2, 3, 4, 5, 8, 9, krn} & set(range(1, krn + 1))):
                    for rows in sorted({r_ for r_ in (8, 16, 24, 32, 64) if r_ < h} | {h}):
                        for tw in sorted({w, cdiv(w, 2), g.tw, r.tw}):
                            if (kg * ntg > kdw.K6_GEN_NPX or kdw.k6_gen_smem(
                                    h, w, k, d, tj, ntg, kg, tw, elem) > kdw.SMEM_LIMIT):
                                continue
                            cut = forced_cut(kdw, g, n, h, w, k, d, elem, tj, kg, rows, tw)
                            t = event_ms(lambda: kdw._launch_k6_gen(x, dy, k, d, cut))
                            res.append((t, tj, kg, rows, tw))
                            print(f"  cut {(n, h, w, c, k, d)} e{elem} tj {tj} ntg {ntg} kg {kg} "
                                  f"rows {rows} tw {tw}: {t:.4f} ms", flush=True)
            res.sort()
            best = min(res[0][0], t_plan, t_rule)
            ratios.append(("held out" if (n, h, w, c, k, d) in HELD_OUT else "fitted",
                           t_plan / best, t_rule / best))
            print(f"{shape}: the plan's cut {t_plan:.4f} ms ({t_plan / best:.3f} of the best), "
                  f"the rule's {t_rule:.4f} ms ({t_rule / best:.3f}), faster than the plan "
                  f"{sum(t < t_plan for t, *_ in res)} of {len(res)}; best "
                  + "; ".join(f"{t:.4f} (tj {a}, kg {b}, rows {r_}, tw {tw})"
                              for t, a, b, r_, tw in res[:5]), flush=True)
    for group in ("fitted", "held out"):
        for i, who in ((1, "the plan"), (2, "the rule")):
            v = [rt[i] for rt in ratios if rt[0] == group]
            if v:
                print(f"k6_gen_cuts: {who} over the best forced cut, {len(v)} runs at the "
                      f"{group} shapes: geometric mean {math.exp(sum(map(math.log, v)) / len(v)):.3f}"
                      f", largest {max(v):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
