"""unet_ms.serve (ms; layer: U-Net, ``models/partial_convolution.py`` and
``ops/partial_conv.py``; moves serve_pages_per_s).

The median of CUDA events around ``pipe.unet(x * valid, valid)`` on one
batch under ``no_grad``, valid the program's own mask of that batch (the
runner's ``unet`` spans)."""

FAMILIES = ()


def read(ctx):
    v = ctx.spans.median("unet")
    return None if v is None else v * 1e3
