"""dw_conv_roofline.train (%; layer: depthwise conv, ``ops/depthwise.py``,
``ops/kernels/depthwise_conv.py``; moves train_pages_per_s).

The least time of the depthwise convs that the step runs on the program's
depthwise kernel, over the device time of the operations launched under
the program's span ``dw.conv`` (each launch of that kernel, forward and
stride-1 dx) per step (the window's ``train.update`` spans), by
``portbench/parts.py``'s rule. The least time is ``work.bound`` of the
bytes, from ``work.products``: for every 3x3 depthwise conv, x read once,
y written once and the weights read once; for those of stride 1 whose
input takes a gradient, dy read once and dx written once besides; all in
the configuration's compute dtype. Where the program has no such span
(before the kernel), nothing is read."""

from portbench import parts, work

FAMILIES = ()
ELEM = {"bfloat16": 2, "float32": 4}


def bound_ms(cfg: dict, kind: str, batch: int) -> float:
    elem = ELEM[cfg["compute_dtype"]]
    total = 0
    for r in work.products(cfg, kind, batch):
        n, c, h, w = r["x"]
        if r["kind"] != "conv" or not r["groups"] == c == r["w"][0] > 1 or r["w"][2] != 3:
            continue
        x, y = n * c * h * w, r["y"][0] * r["y"][1] * r["y"][2] * r["y"][3]
        total += x + y + c * 9
        if kind != "serve" and r["stride"] == 1 and r["x_grad"]:
            total += y + x
    return work.bound(0.0, total * elem)[0]


def read(ctx, kind: str = "seg", per: str = "train.update"):
    p = parts.of(ctx)
    if p is None or not p.count(per) or not p.device_s.get("dw.conv"):
        return None
    return 100.0 * bound_ms(ctx.config, kind, ctx.traffic["batch"]) * p.count(per) / (
        p.device_s["dw.conv"] * 1e3)
