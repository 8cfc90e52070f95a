"""segmenter_ms.serve (ms; layer: segmenter, ``models/text_segmentation.py``,
``models/mobilenet_v2.py``, ``models/xception.py``; moves
serve_pages_per_s).

The median of CUDA events around ``pipe.seg(x)`` on one batch under
``no_grad`` (the runner's ``segmenter`` spans)."""

FAMILIES = ()


def read(ctx):
    v = ctx.spans.median("segmenter")
    return None if v is None else v * 1e3
