"""mfu.card_paced (%; layer: the whole step; moves
train_pages_per_s.card_paced).

``mfu.train``'s reading, in the training cells whose pace the card
sets and whose throughput is held to a bound of its own."""

from portbench.harness import metric_module

_TRAIN = metric_module("mfu.train")
FAMILIES = _TRAIN.FAMILIES
read = _TRAIN.read
