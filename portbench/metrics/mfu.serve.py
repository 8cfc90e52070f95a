"""mfu.serve (%; layer: the whole step; moves serve_pages_per_s).

Useful FLOPs per page of the page cleaner's forward (``work.useful_flops``
'serve': the segmenter and the U-Net's products with x), times the
traced run's served pages per second, over the card's dense bf16 peak."""

from portbench import work

FAMILIES = ()


def read(ctx):
    rate = ctx.window.get("serve_pages_per_s")
    if not rate:
        return None
    return 100.0 * work.useful_flops(ctx.config, "serve") * rate / work.PEAK_BF16
