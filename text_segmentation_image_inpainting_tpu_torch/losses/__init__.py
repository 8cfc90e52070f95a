"""Training losses of the port (the inpainting suite so far)."""

from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
    InpaintLossConfig,
    gram_matrix,
    inpainting_loss,
    make_vgg,
    total_variation_loss,
)

__all__ = [
    "InpaintLossConfig",
    "gram_matrix",
    "inpainting_loss",
    "make_vgg",
    "total_variation_loss",
]
