"""Training of the port: segmentation and inpainting."""

from text_segmentation_image_inpainting_tpu_torch.train.config import (
    InpaintTrainConfig,
    OptimizerConfig,
    SegTrainConfig,
)
from text_segmentation_image_inpainting_tpu_torch.train.accum import accumulate_grads
from text_segmentation_image_inpainting_tpu_torch.train.inpaint import (
    make_inpaint_eval_step,
    make_inpaint_train_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.multistep import (
    clamp_steps_per_dispatch,
    make_multi_step,
    stack_host_batches,
)
from text_segmentation_image_inpainting_tpu_torch.train.seg import (
    make_seg_eval_step,
    make_seg_train_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    freeze_mask_for,
    make_optimizer,
)

__all__ = [
    "InpaintTrainConfig",
    "OptimizerConfig",
    "SegTrainConfig",
    "TrainState",
    "accumulate_grads",
    "clamp_steps_per_dispatch",
    "create_train_state",
    "freeze_mask_for",
    "make_inpaint_eval_step",
    "make_inpaint_train_step",
    "make_multi_step",
    "make_optimizer",
    "make_seg_eval_step",
    "make_seg_train_step",
    "stack_host_batches",
]
