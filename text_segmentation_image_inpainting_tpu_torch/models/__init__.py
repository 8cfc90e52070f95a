"""``nn.Module``s of the page pipeline (NHWC activations)."""

from text_segmentation_image_inpainting_tpu_torch.models.experiments import (
    SelfAttention2d,
    SpectralNormConv2d,
)
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
    DeepLabASPPDecoder,
    TextSegament,
    TextSegmenter,
)
from text_segmentation_image_inpainting_tpu_torch.models.xception import XceptionEncoder

__all__ = [
    "ConvBNAct",
    "DeepLabASPPDecoder",
    "InvertedResidual",
    "MobileNetV2Encoder",
    "InpaintUNet",
    "PartialConv",
    "SelfAttention2d",
    "SpectralNormConv2d",
    "TextSegament",
    "TextSegmenter",
    "XceptionEncoder",
]
