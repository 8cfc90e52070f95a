"""PyTorch/CUDA port of ``text_segmentation_image_inpainting_tpu``.

The JAX package beside this one is the reference. This package runs the
segment -> dilate -> inpaint page pipeline in PyTorch, with the U-Net's
stride-1 partial convolutions on hand-written CUDA kernels for Hopper
(``csrc/partial_conv.cu``, built with nvcc at first use). It never
imports jax or flax.

Layout mirrors the JAX package:
  ops/       torch-padding convs, resize, mask morphology, partial conv
             (routing) and ``ops/kernels`` (the CUDA kernels' wrappers,
             their plain versions and the nvcc build)
  models/    MobileNetV2 encoder, TextSegmenter, PartialConv / InpaintUNet
  pipeline/  the end-to-end page pipeline
  compat/    flax variables -> this package's state_dict
"""

__version__ = "0.1.0"
