"""device_idle_pct.card_paced (%; layer: the device; moves
train_pages_per_s.card_paced).

``device_idle_pct.train``'s reading, in the training cells whose pace the card
sets and whose throughput is held to a bound of its own."""

from portbench.harness import metric_module

_TRAIN = metric_module("device_idle_pct.train")
FAMILIES = _TRAIN.FAMILIES
read = _TRAIN.read
