"""Multi-device serving and training: the mesh (devices in one process, or
one rank per device), H-sharded execution with halo exchange, the two-stage
(segment | inpaint) pipeline, and two-group training.

Counterpart of ``text_segmentation_image_inpainting_tpu/parallel/``.
"""

from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    gather,
    initialize_distributed,
    make_array_from_process_local_data,
    make_hybrid_mesh,
    make_mesh,
    make_mesh_for_batch,
    make_rank_mesh,
    replicate,
    replicated,
    shard_batch,
    stacked_batch_sharding,
)
from text_segmentation_image_inpainting_tpu_torch.parallel.spatial import (
    spatial_conv2d,
    spatial_inpaint_unet,
    spatial_partial_conv2d,
    spatial_pipeline_run,
)
from text_segmentation_image_inpainting_tpu_torch.parallel.stage_pipeline import (
    concurrent_train2,
    make_group_meshes,
    make_stage_mesh,
    pipeline2_run,
    pipeline2_throughput_model,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "gather",
    "initialize_distributed",
    "make_array_from_process_local_data",
    "make_hybrid_mesh",
    "make_mesh",
    "make_mesh_for_batch",
    "make_rank_mesh",
    "replicate",
    "replicated",
    "shard_batch",
    "stacked_batch_sharding",
    "spatial_conv2d",
    "spatial_inpaint_unet",
    "spatial_partial_conv2d",
    "spatial_pipeline_run",
    "concurrent_train2",
    "make_group_meshes",
    "make_stage_mesh",
    "pipeline2_run",
    "pipeline2_throughput_model",
]
