"""Training losses of the port: the inpainting suite and the segmentation losses."""

from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
    InpaintLossConfig,
    gram_matrix,
    inpainting_loss,
    make_vgg,
    total_variation_loss,
)
from text_segmentation_image_inpainting_tpu_torch.losses.segmentation import (
    bce_with_logits,
    dice_loss,
    focal_loss,
    segmentation_loss,
)

__all__ = [
    "InpaintLossConfig",
    "bce_with_logits",
    "dice_loss",
    "focal_loss",
    "gram_matrix",
    "inpainting_loss",
    "make_vgg",
    "segmentation_loss",
    "total_variation_loss",
]
