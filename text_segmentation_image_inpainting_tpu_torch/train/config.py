"""Training configs, one small frozen dataclass per task.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/config.py``:
the same fields and defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import InpaintLossConfig


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    # 'adam' (default; ``amsgrad`` upgrades it) | 'sgd' (beta1 as momentum).
    # SGD matters for exactness tests: Adam's lr*m/(sqrt(v)+eps) amplifies
    # ulp-level gradient differences up to ~2*lr on near-zero grads.
    kind: str = "adam"
    learning_rate: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    amsgrad: bool = False
    grad_clip_norm: float | None = None
    warmup_steps: int = 0
    # cosine warm-restart period (0 = constant LR)
    restart_period: int = 0
    # number of warm-restart cycles; the schedule holds its end value after
    restart_cycles: int = 50


@dataclasses.dataclass(frozen=True)
class SegTrainConfig:
    image_size: Tuple[int, int] = (512, 512)
    batch_size: int = 8
    width_mult: float = 1.0
    output_stride: int = 8
    decoder_mid: int = 128
    backbone: str = "mobilenet_v2"
    head: str = "mini"
    bce_weight: float = 1.0
    dice_weight: float = 1.0
    focal_weight: float = 0.0
    pos_weight: float | None = 3.0
    freeze_encoder: bool = False
    grad_accum: int = 1
    optimizer: OptimizerConfig = OptimizerConfig()
    bf16_compute: bool = True
    checkpoint_every: int = 500
    log_every: int = 50


@dataclasses.dataclass(frozen=True)
class InpaintTrainConfig:
    image_size: Tuple[int, int] = (512, 512)
    batch_size: int = 8
    depth: int = 8
    # training default: bf16 VGG trunk (f32 term accumulation in the loss)
    loss: InpaintLossConfig = InpaintLossConfig(vgg_dtype="bfloat16")
    # U-Net rematerialisation: 'none' (keep activations) | 'full'
    # (torch.utils.checkpoint around the U-Net forward)
    remat: str = "none"
    # the paper's phase-2 fine-tune: freeze ENCODER BN only
    freeze_bn: bool = False
    attention: bool = False
    attention_sn: bool = False
    grad_accum: int = 1
    optimizer: OptimizerConfig = OptimizerConfig()
    bf16_compute: bool = True
    pconv_impl: str = "xla"
    checkpoint_every: int = 500
    log_every: int = 50
