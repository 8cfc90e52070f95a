"""seg_stage_device_ms.serve (ms; layer: segmenter,
``pipeline/end_to_end.py::_segment2d``, ``models/text_segmentation.py``,
``models/mobilenet_v2.py``; moves serve_pages_per_s).

Device time of the operations launched under the program's span
``pipeline.segment`` (the segmenter, the threshold and the dilation) in
the served stream, per span, by ``portbench/parts.py``'s rule."""

from portbench import parts

FAMILIES = ()


def read(ctx):
    return parts.device_ms(ctx, "pipeline.segment", per="pipeline.segment")
