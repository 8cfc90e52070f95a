"""stem_roofline.train (%; layer: kernels K4/K5, ``ops/kernels/vgg_stem.py``;
moves train_pages_per_s).

The least time of one step's fused VGG stem, K4 (the stem's data gradient
on the output and the composite, 2B pages) and K5 (its pooled forward on
the ground truth, B pages) by ``work.stem_dx_work``/``stem_pool_work``
and ``work.bound``, over the profiled device time of the kernels named
here per step (the window holds whole steps)."""

from portbench import work

FAMILIES = ("stem_dx", "stem_pool")


def read(ctx):
    t = ctx.trace.time(FAMILIES)
    if t <= 0 or not ctx.units:
        return None
    b, (h, w) = ctx.traffic["batch"], ctx.config["image_size"]
    ms = work.bound(*work.stem_dx_work(2 * b, h, w))[0] + work.bound(
        *work.stem_pool_work(b, h, w))[0]
    return 100.0 * ms * ctx.units / (t * 1e3)
