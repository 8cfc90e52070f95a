"""bn_device_ms.card_paced (ms; layer: BatchNorm glue; moves
train_pages_per_s.card_paced).

``bn_device_ms.train``'s reading, in the training cells whose pace the card
sets and whose throughput is held to a bound of its own."""

from portbench.harness import metric_module

_TRAIN = metric_module("bn_device_ms.train")
FAMILIES = _TRAIN.FAMILIES
read = _TRAIN.read
