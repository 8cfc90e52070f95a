"""dw_wgrad_roofline.train (%; layer: kernel K6, ``ops/depthwise.py`` and
``ops/kernels/depthwise_wgrad.py``; moves train_pages_per_s).

The least time of every depthwise weight gradient that the step routes to
K6 (stride 1, odd k, depthwise, at least 128 channels: the program's rule
with its flag on, as of this file) by ``work.k6_work`` and ``work.bound``
summed layer by layer, over the profiled device time of the kernels named
here per step (the window holds whole steps)."""

from portbench import work

FAMILIES = ("dw_wgrad",)


def bound_ms(cfg: dict, batch: int) -> float:
    total = 0.0
    for r in work.products(cfg, "seg", batch):
        n, c, h, w = r["x"]
        k = r["w"][2]
        if (r["kind"] == "conv" and r["groups"] == c == r["w"][0] and r["stride"] == 1
                and k % 2 == 1 and c >= 128):
            total += work.bound(*work.k6_work((n, h, w, c), k, r["dilation"]))[0]
    return total


def read(ctx):
    t = ctx.trace.time(FAMILIES)
    if t <= 0 or not ctx.units:
        return None
    return 100.0 * bound_ms(ctx.config, ctx.traffic["batch"]) * ctx.units / (t * 1e3)
