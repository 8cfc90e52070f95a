"""pconv_fwd_roofline.serve (%; layer: kernels K1/K2,
``ops/kernels/partial_conv.py``; moves serve_pages_per_s).

The least time of the U-Net's stride-1 partial convs' forward per batch
(the decoder's levels and the head; ``work.pconv_work`` and
``work.bound`` at their shapes, summed layer by layer) over the profiled
device time of the kernels named here per batch. A batch's kernels are
K1's seven and the head's one (``pconv_k2``), in that order on one
stream, so the time is counted between the first and the last head
kernel of the window: exactly the batches that lie whole between them."""

from portbench import work

FAMILIES = ("pconv_k1", "pconv_k2")
EXCLUDE = ("pconv_k2_bwd", "pconv_k2f")
HEAD = "pconv_k2"


def bound_ms(cfg: dict, batch: int) -> float:
    total = 0.0
    for r in work.products(cfg, "serve", batch):
        if r["kind"] == "pconv" and r["stride"] == 1:
            n, c, h, w = r["x"]
            total += work.bound(*work.pconv_work((n, h, w, c), (n, h, w, r["mask_groups"]),
                                                 r["w"]))[0]
    return total


def read(ctx):
    ops = sorted(ctx.trace.ops, key=lambda o: o[1])
    heads = [e for n, s, e in ops if n == HEAD]
    if len(heads) < 2:
        return None
    t = sum(e - s for n, s, e in ops
            if n.startswith(FAMILIES) and not n.startswith(EXCLUDE) and heads[0] < s < heads[-1])
    if t <= 0:
        return None
    runs = len(heads) - 1
    return 100.0 * bound_ms(ctx.config, ctx.traffic["batch"]) * runs / (t * 1e3)
