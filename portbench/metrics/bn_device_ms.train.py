"""bn_device_ms.train (ms; layer: BatchNorm glue,
``models/mobilenet_v2.py::BatchNorm``; moves train_pages_per_s).

Device time of BatchNorm's glue per step (the window's ``train.update``
spans): the operations launched under the program's span ``bn`` and,
in the backward, those of the autograd nodes whose forward op ran under
``bn``, by ``portbench/parts.py``'s rule."""

from portbench import parts

FAMILIES = ()


def read(ctx):
    return parts.device_ms(ctx, "bn", per="train.update")
