from text_segmentation_image_inpainting_tpu_torch.pipeline.end_to_end import (
    TextRemovalPipeline,
    pad_to_multiple,
    preprocess_page,
)
from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import PageStreamServer

__all__ = ["TextRemovalPipeline", "pad_to_multiple", "preprocess_page", "PageStreamServer"]
