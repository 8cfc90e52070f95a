"""mfu.train (%; layer: the whole step; moves train_pages_per_s).

Useful FLOPs per page of the cell's training step (``work.useful_flops``
of the traffic's task: forward, the data and weight gradients where
needed, the frozen VGG16 and the Grams for inpainting), times the traced
run's trained pages per second, over the card's dense bf16 peak."""

from portbench import work

FAMILIES = ()


def read(ctx):
    rate = ctx.window.get("train_pages_per_s")
    if not rate:
        return None
    return 100.0 * work.useful_flops(ctx.config, ctx.traffic["task"]) * rate / work.PEAK_BF16
