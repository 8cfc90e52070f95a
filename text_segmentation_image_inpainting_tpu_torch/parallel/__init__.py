"""Multi-device serving: the data-parallel mesh, H-sharded execution with
halo exchange, and the two-stage (segment | inpaint) pipeline.

Counterpart of ``text_segmentation_image_inpainting_tpu/parallel/``, its
serving half.
"""

from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import (
    Mesh,
    gather,
    make_mesh,
    make_mesh_for_batch,
    replicate,
    shard_batch,
)
from text_segmentation_image_inpainting_tpu_torch.parallel.spatial import (
    spatial_conv2d,
    spatial_inpaint_unet,
    spatial_partial_conv2d,
)
from text_segmentation_image_inpainting_tpu_torch.parallel.stage_pipeline import (
    make_stage_mesh,
    pipeline2_run,
    pipeline2_throughput_model,
)

__all__ = [
    "Mesh",
    "gather",
    "make_mesh",
    "make_mesh_for_batch",
    "replicate",
    "shard_batch",
    "spatial_conv2d",
    "spatial_inpaint_unet",
    "spatial_partial_conv2d",
    "make_stage_mesh",
    "pipeline2_run",
    "pipeline2_throughput_model",
]
