"""inpaint_stage_device_ms.serve (ms; layer: U-Net,
``pipeline/end_to_end.py::_inpaint2d``, ``models/partial_convolution.py``;
moves serve_pages_per_s).

Device time of the operations launched under the program's span
``pipeline.inpaint`` (the U-Net and the composite) in the served stream,
per span, by ``portbench/parts.py``'s rule."""

from portbench import parts

FAMILIES = ()


def read(ctx):
    return parts.device_ms(ctx, "pipeline.inpaint", per="pipeline.inpaint")
