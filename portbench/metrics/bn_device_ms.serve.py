"""bn_device_ms.serve (ms; layer: BatchNorm glue,
``models/mobilenet_v2.py::BatchNorm``; moves serve_pages_per_s).

Device time of the operations launched under the program's span ``bn``
(the whole of ``BatchNorm.forward``: the f32 casts and the affine) per
served batch (the window's ``serve.dispatch`` spans), by
``portbench/parts.py``'s rule."""

from portbench import parts

FAMILIES = ()


def read(ctx):
    return parts.device_ms(ctx, "bn", per="serve.dispatch")
