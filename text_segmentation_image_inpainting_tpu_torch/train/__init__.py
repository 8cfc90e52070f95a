"""Training of the port (inpainting so far)."""

from text_segmentation_image_inpainting_tpu_torch.train.config import (
    InpaintTrainConfig,
    OptimizerConfig,
    SegTrainConfig,
)
from text_segmentation_image_inpainting_tpu_torch.train.inpaint import (
    make_inpaint_eval_step,
    make_inpaint_train_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_optimizer,
)

__all__ = [
    "InpaintTrainConfig",
    "OptimizerConfig",
    "SegTrainConfig",
    "TrainState",
    "create_train_state",
    "make_inpaint_eval_step",
    "make_inpaint_train_step",
    "make_optimizer",
]
