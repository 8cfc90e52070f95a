"""dw_conv_roofline.serve (%; layer: depthwise conv, ``ops/depthwise.py``,
``ops/kernels/depthwise_conv.py``; moves serve_pages_per_s).

``dw_conv_roofline.train``'s reading for the served pipeline: the bound of
the segmenter's forward depthwise convs (x read, y written, the weights
read, once each) per served batch (the window's ``serve.dispatch`` spans)
over the device time under ``dw.conv``."""

from portbench.harness import metric_module

_TRAIN = metric_module("dw_conv_roofline.train")
FAMILIES = _TRAIN.FAMILIES


def read(ctx):
    return _TRAIN.read(ctx, kind="serve", per="serve.dispatch")
