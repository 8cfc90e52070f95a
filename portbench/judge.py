"""How ``correct`` is decided: the numbers compared with the plain f32
reference, and their limits.

A served cell compares, over a sample of the batches served in the
window (drawn from the seed), the program's uint8 answers with the
reference's on the same pages:

  mask_margin      the widest margin by which the reference contradicts a
                   served mask pixel: over the pixels where the served
                   mask and the reference's (thresholded, dilated) differ,
                   the largest distance of the reference's window-max
                   logit from the threshold, over the standard deviation
                   of the reference's logits on that batch. Random weights
                   put many pixels near the threshold, so how many flip
                   swings from seed to seed; by how much the reference
                   disagrees does not (``mask_flip_pct`` is kept beside it
                   for the record, not compared)
  clean_hole_mae   the mean |difference| in uint8 levels, over the pixels
                   the served mask marks as text, between the served page
                   and the reference U-Net's composite over that mask
  clean_valid_max  the largest |difference| in uint8 levels over the
                   pixels the served mask leaves alone (the program keeps
                   them up to its rounding of the page)

A training cell compares the first three steps, which set-up drives
through the window's own call, with the reference's three steps from the
same weights and batches:

  loss_gap         the largest |L - L_ref| / |L_ref| over the steps
  loss1_gap        the same of the first step alone, which only the
                   weights from the seed and the first batch set
  grad_gap         the worst leaf's | |g| - |g_ref| | over the larger of
                   |g_ref| of that leaf and of the median leaf, g the first
                   step's gradient (the program's read from Adam's first
                   moment, m / (1 - beta1))
  change_gap       the same of each leaf's change over the three steps
                   (parameters and BatchNorm statistics)
  stats_gap        the same over the BatchNorm running statistics alone,
                   against the median statistic leaf: they move with each
                   batch's own mean and variance
  stats1_gap       the same of their change in the first step alone, which
                   only the first batch and the weights from the seed set
  stats1_var_gap   the same over the running variances alone, against the
                   median variance leaf: each BatchNorm's variance over
                   the batch's pages, which half a batch moves most
  *_median_gap     the median leaf's gap in place of the worst's

Both leave out the parameters whose reference gradient is under a
thousandth of the median leaf's: nought to rounding, as a BatchNorm's
bias before another BatchNorm (its gradient cancels exactly), whose
gradient is the program's cancellation error and which Adam then moves
by round-off alone.

Each number passes when it is at most its limit (``limits/<cell>.json``).
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np

LIMITS = Path(__file__).resolve().parent / "limits"


def limits_for(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())["limits"]


def serve_numbers(answers: list, threshold: float) -> dict:
    """``answers``: (served clean, served text, the reference's window-max
    logits, their batch's logit standard deviation, the reference's clean
    page over the served text), numpy arrays, per sampled batch."""
    flips = total = 0
    hole_sum = hole_n = 0.0
    valid_max, margin = 0, 0.0
    for clean, text, score, spread, ref_clean in answers:
        wrong = text.astype(bool) != (score > threshold)
        flips += int(np.count_nonzero(wrong))
        total += text.size
        if wrong.any():
            margin = max(margin, float(np.abs(score[wrong] - threshold).max()) / spread)
        d = np.abs(clean.astype(np.int16) - ref_clean.astype(np.int16))
        t = np.broadcast_to(text.astype(bool), d.shape)
        hole_sum += float(d[t].sum())
        hole_n += float(t.sum())
        if (~t).any():
            valid_max = max(valid_max, int(d[~t].max()))
    return {"mask_margin": margin, "mask_flip_pct": 100.0 * flips / max(total, 1),
            "clean_hole_mae": hole_sum / max(hole_n, 1.0),
            "clean_valid_max": float(valid_max)}


def _leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each kept leaf's gap: | |prog| - |ref| | over the larger of its
    reference norm and the median leaf's."""
    med = statistics.median(ref.values())
    return {k: abs(prog.get(k, 0.0) - r) / max(r, med, 1e-30) for k, r in ref.items() if keep(k)}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {'loss': [...], 'grad': {leaf: norm},
    'change': {leaf: norm}}."""
    steps = [abs(a - b) / max(abs(b), 1e-30) if np.isfinite(a) else float("inf")
             for a, b in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        steps = [float("inf")]
    floor = 1e-3 * statistics.median(ref["grad"].values())
    moving = lambda k: k not in ref["grad"] or ref["grad"][k] >= floor  # noqa: E731
    out = {"loss_gap": max(steps), "loss1_gap": steps[0], "loss_steps": steps}
    stats = lambda k: k.endswith(("running_mean", "running_var"))  # noqa: E731
    var = lambda k: k.endswith("running_var")  # noqa: E731
    for what, src, keep in (("grad", "grad", moving), ("change", "change", moving),
                            ("stats", "change", stats), ("stats1", "stats1", stats),
                            ("stats1_var", "stats1", var)):
        ref_w = {k: v for k, v in ref[src].items() if keep(k)}
        gaps = _leaf_gaps(prog[src], ref_w, lambda k: True)
        worst = max(gaps, key=gaps.get)
        out.update({f"{what}_gap": gaps[worst], f"{what}_leaf": worst,
                    f"{what}_median_gap": statistics.median(gaps.values())})
    out["left_out"] = sorted(k for k in ref["grad"] if not moving(k))
    return out


def checks(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: [value, limit]}); a number that is not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        if name not in numbers:
            raise KeyError(f"the limits name {name!r}, which the judge does not compare")
        v = float(numbers[name])
        out[name] = [v, limit]
        ok = ok and bool(np.isfinite(v)) and v <= limit
    return ok, out
