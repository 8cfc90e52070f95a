"""k3_roofline.train (%; layer: kernel K3, ``ops/kernels/partial_conv.py``
``partial_conv2d_backward``; moves train_pages_per_s).

The least time of the backward of the U-Net's stride-1 partial convs per
step (the decoder's levels and the head: dx and dW by
``work.pconv_bwd_work`` and ``work.bound`` at their shapes, summed layer
by layer) over the device time of the operations launched under the
program's span ``pconv.k3`` (prep, mask, the library's product or
``pconv_k2_bwd``, colsum) per step (the window's ``train.update`` spans),
by ``portbench/parts.py``'s rule."""

from portbench import parts, work

FAMILIES = ()


def bound_ms(cfg: dict, batch: int) -> float:
    total = 0.0
    for r in work.products(cfg, "inpaint", batch):
        if r["kind"] == "pconv" and r["stride"] == 1:
            n, c, h, w = r["x"]
            total += work.bound(*work.pconv_bwd_work(
                (n, h, w, c), (n, h, w, r["mask_groups"]), r["w"], (n, h, w, r["w"][0])))[0]
    return total


def read(ctx):
    p = parts.of(ctx)
    if p is None or not p.count("train.update") or not p.device_s.get("pconv.k3"):
        return None
    steps = p.count("train.update")
    return 100.0 * bound_ms(ctx.config, ctx.traffic["batch"]) * steps / (
        p.device_s["pconv.k3"] * 1e3)
