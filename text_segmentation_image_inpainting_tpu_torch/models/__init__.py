"""``nn.Module``s of the page pipeline (NHWC activations)."""

from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import (
    ConvBNAct,
    InvertedResidual,
    MobileNetV2Encoder,
)
from text_segmentation_image_inpainting_tpu_torch.models.partial_convolution import (
    InpaintUNet,
    PartialConv,
)
from text_segmentation_image_inpainting_tpu_torch.models.text_segmentation import (
    TextSegament,
    TextSegmenter,
)

__all__ = [
    "ConvBNAct",
    "InvertedResidual",
    "MobileNetV2Encoder",
    "InpaintUNet",
    "PartialConv",
    "TextSegament",
    "TextSegmenter",
]
