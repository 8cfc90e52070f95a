"""PyTorch/CUDA port of ``text_segmentation_image_inpainting_tpu``.

The JAX package beside this one is the reference. This package runs the
segment -> dilate -> inpaint page pipeline and the inpainting trainer in
PyTorch, with the U-Net's stride-1 partial convolutions (forward and
backward) and the frozen VGG16 stem of the loss on hand-written CUDA
kernels for Hopper (``csrc/*.cu``, built with nvcc at first use). It
never imports jax or flax.

Layout mirrors the JAX package:
  ops/       torch-padding convs, resize, mask morphology, partial conv
             (routing) and ``ops/kernels`` (the CUDA kernels' wrappers,
             their plain versions and the nvcc build)
  models/    MobileNetV2 encoder, TextSegmenter, PartialConv / InpaintUNet,
             the frozen VGG16 feature trunk
  pipeline/  the end-to-end page pipeline
  losses/    the inpainting loss (L1, perceptual, style, TV)
  train/     configs, optimizer and train state, the inpainting step,
             metrics, checkpoints, validation and the ``run_inpaint`` CLI
  data/      inpainting page batches
  compat/    flax variables -> this package's state_dict
"""

__version__ = "0.1.0"
