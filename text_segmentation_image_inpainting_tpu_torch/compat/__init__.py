"""Weight bridges into the port's ``state_dict`` names: ``from_jax`` from
the JAX package's flax variables, ``torchvision`` from torchvision's
``mobilenet_v2`` and ``vgg16`` checkpoints (``verify_pretrained`` is the
runbook that checks such a file end to end)."""
