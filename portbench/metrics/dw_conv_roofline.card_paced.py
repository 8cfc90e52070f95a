"""dw_conv_roofline.card_paced (%; layer: depthwise conv; moves
train_pages_per_s.card_paced).

``dw_conv_roofline.train``'s reading, in the training cells whose pace the
card sets and whose throughput is held to a bound of its own."""

from portbench.harness import metric_module

_TRAIN = metric_module("dw_conv_roofline.train")
FAMILIES = _TRAIN.FAMILIES
read = _TRAIN.read
