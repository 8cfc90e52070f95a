"""One rank of the port's data-parallel CPU tests (``tests/test_torch_ddp.py``).

Run as ``python tests/torch_ddp_worker.py JOB RANK WORLD PORT WORKDIR``:
joins a gloo group of WORLD processes at tcp://127.0.0.1:PORT, reads the
weights and batches the test wrote to WORKDIR/inputs.pt, runs JOB and
writes what it found to WORKDIR/JOB_RANK.pt. Imports torch and the port
only.

Jobs:
  pair  (2 ranks) the seg step (float64) and the inpaint step (float32)
        over the 2-rank mesh, also with each rank's own BatchNorm
        statistics; two seg steps as one multi-step over
        ``stacked_batch_sharding`` (also through ``DevicePrefetcher``'s
        ``sharding``) and as two single steps; the val
        batches over the mesh, scored by the eval steps.
  quad  (4 ranks, two hosts faked through GROUP_RANK: ranks 0, 2 and
        1, 3) ``make_hybrid_mesh`` and a sum over it; the rank mesh
        ``make_mesh_for_batch`` narrows for a batch of 6; then
        ``concurrent_train2`` over ``make_group_meshes``: ranks 0-1 train
        the segmenter, ranks 2-3 the U-Net.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from text_segmentation_image_inpainting_tpu_torch import parallel  # noqa: E402
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import load_state_dict  # noqa: E402
from text_segmentation_image_inpainting_tpu_torch.data.pipeline import DevicePrefetcher  # noqa: E402
from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (  # noqa: E402
    InpaintLossConfig,
)
from text_segmentation_image_inpainting_tpu_torch.models import (  # noqa: E402
    InpaintUNet,
    TextSegmenter,
)
from text_segmentation_image_inpainting_tpu_torch.models.vgg import VGG16Features  # noqa: E402
from text_segmentation_image_inpainting_tpu_torch.ops import collectives  # noqa: E402
from text_segmentation_image_inpainting_tpu_torch.train import config as tconfig  # noqa: E402
from text_segmentation_image_inpainting_tpu_torch.train.inpaint import (  # noqa: E402
    make_inpaint_eval_step,
    make_inpaint_train_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.multistep import (  # noqa: E402
    make_multi_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.seg import (  # noqa: E402
    make_seg_eval_step,
    make_seg_train_step,
)
from text_segmentation_image_inpainting_tpu_torch.train.state import (  # noqa: E402
    create_train_state,
)
from text_segmentation_image_inpainting_tpu_torch.train.val import (  # noqa: E402
    make_val_batches,
    scored_eval,
)

HW, LR, WIDTH, DEPTH, BATCH = (32, 32), 0.01, 0.35, 3, 4


def seg_cfg():
    return tconfig.SegTrainConfig(image_size=HW, batch_size=BATCH, width_mult=WIDTH,
                                  optimizer=tconfig.OptimizerConfig(kind="sgd", learning_rate=LR))


def inpaint_cfg():
    return tconfig.InpaintTrainConfig(
        image_size=HW, batch_size=BATCH, depth=DEPTH, loss=InpaintLossConfig(fused_stem=True),
        optimizer=tconfig.OptimizerConfig(kind="sgd", learning_rate=LR))


def seg_model(inputs):
    model = TextSegmenter(width_mult=WIDTH, dtype=torch.float64).double()
    load_state_dict(model, inputs["seg"])
    return model


def unet_model(inputs):
    model = InpaintUNet(depth=DEPTH)
    load_state_dict(model, inputs["unet"])
    return model


def vgg_model(inputs):
    model = VGG16Features()
    load_state_dict(model, inputs["vgg"])
    return model


def state_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def seg_run(inputs, mesh, batches):
    """The seg step over ``mesh`` on each global batch in turn."""
    model = seg_model(inputs)
    state = create_train_state(model, seg_cfg().optimizer)
    step = make_seg_train_step(model, seg_cfg(), mesh=mesh)
    metrics = []
    for batch in batches:
        state, m = step(state, parallel.shard_batch(mesh, batch))
        metrics.append({k: v.item() for k, v in m.items()})
    return state_of(model), metrics


def inpaint_run(inputs, mesh, batch):
    model = unet_model(inputs)
    state = create_train_state(model, inpaint_cfg().optimizer)
    step = make_inpaint_train_step(model, inpaint_cfg(), vgg_model(inputs), mesh=mesh)
    state, terms = step(state, parallel.shard_batch(mesh, batch))
    return state_of(model), {k: v.item() for k, v in terms.items()}


def per_rank_statistics():
    """BatchNorm on each rank's own shard: the cross-rank sum undone."""
    collectives.all_reduce_stats = lambda x: x * collectives.dp_world()


def pair(inputs, out):
    mesh = parallel.make_rank_mesh()
    out["position"] = mesh.position()
    sd, (m,) = seg_run(inputs, mesh, [inputs["seg_batch"]])
    out["seg"] = (sd, m)
    out["inpaint"] = inpaint_run(inputs, mesh, inputs["inp_batch"])

    # two steps as one multi-step over the stacked super-batch, and one by one
    stacked = inputs["seg_stacked"]
    model = seg_model(inputs)
    state = create_train_state(model, seg_cfg().optimizer)
    multi = make_multi_step(make_seg_train_step(model, seg_cfg(), mesh=mesh))
    cols = parallel.shard_batch(mesh, stacked, parallel.stacked_batch_sharding(mesh))
    out["stacked_cols"] = cols
    pf = DevicePrefetcher(iter([stacked]), "cpu", sharding=parallel.stacked_batch_sharding(mesh))
    try:
        out["prefetched"] = list(pf)
    finally:
        pf.close()
    state, m = multi(state, cols)
    out["multi"] = (state_of(model), {k: v.tolist() for k, v in m.items()})
    out["singles"] = seg_run(inputs, mesh, [{k: v[i] for k, v in stacked.items()}
                                            for i in range(stacked["image"].shape[0])])

    # the held-out batches over the mesh, scored by the eval steps over it
    seg_val = make_val_batches("seg", seg_cfg(), mesh, seed=inputs["val_seed"], n=1)
    inp_val = make_val_batches("inpaint", inpaint_cfg(), mesh, seed=inputs["val_seed"], n=1)
    out["val_batches"] = (seg_val, inp_val)
    out["val_seg"] = scored_eval(make_seg_eval_step(seg_model(inputs), mesh=mesh), None, seg_val)
    out["val_inpaint"] = scored_eval(make_inpaint_eval_step(unet_model(inputs), mesh=mesh), None,
                                     inp_val)

    per_rank_statistics()
    sd, (m,) = seg_run(inputs, mesh, [inputs["seg_batch"]])
    out["seg_per_rank"] = (sd, m)
    out["inpaint_per_rank"] = inpaint_run(inputs, mesh, inputs["inp_batch"])


def quad(inputs, out):
    mesh = parallel.make_hybrid_mesh()
    out["shape"] = mesh.shape
    out["ranks"] = mesh.ranks.tolist()
    out["position"] = mesh.position()
    sharding = parallel.batch_sharding(mesh)
    local = np.full((1, 4), float(mesh.position()), np.float32)
    garr = parallel.make_array_from_process_local_data(sharding, local, (4, 4))
    with mesh.data_parallel():
        out["total"] = collectives.global_sum(garr.sum()).item()

    narrow = parallel.make_mesh_for_batch(6)  # gcd(4, 6) = 2: ranks 0 and 1
    out["narrow"] = (narrow.ranks.ravel().tolist(), narrow.position())

    seg_mesh, inp_mesh = parallel.make_group_meshes()
    out["groups"] = (seg_mesh.ranks.ravel().tolist(), inp_mesh.ranks.ravel().tolist())
    mine_seg = seg_mesh.position() is not None
    seg_state = inp_state = seg_batch = inp_batch = None
    if mine_seg:
        seg_m = seg_model(inputs)
        seg_state = create_train_state(seg_m, seg_cfg().optimizer)
        seg_batch = parallel.shard_batch(seg_mesh, inputs["seg_batch"])
    else:
        inp_m = unet_model(inputs)
        inp_state = create_train_state(inp_m, inpaint_cfg().optimizer)
        inp_batch = parallel.shard_batch(inp_mesh, inputs["inp_batch"])
    seg_step = make_seg_train_step(seg_m if mine_seg else None, seg_cfg(), mesh=seg_mesh)
    inp_step = make_inpaint_train_step(None if mine_seg else inp_m, inpaint_cfg(),
                                       None if mine_seg else vgg_model(inputs), mesh=inp_mesh)
    step = parallel.concurrent_train2(seg_step, inp_step)
    seg_state, seg_metrics, inp_state, inp_metrics = step(seg_state, seg_batch, inp_state,
                                                          inp_batch)
    if mine_seg:
        out["seg"] = (state_of(seg_m), {k: v.item() for k, v in seg_metrics.items()})
        assert inp_state is None and inp_metrics is None
    else:
        out["inpaint"] = (state_of(inp_m), {k: v.item() for k, v in inp_metrics.items()})
        assert seg_state is None and seg_metrics is None


def main():
    job, rank, world, port, work = sys.argv[1:6]
    rank, world, work = int(rank), int(world), Path(work)
    torch.set_num_threads(1)
    if job == "quad":
        os.environ["GROUP_RANK"] = str(rank % 2)
    device = parallel.initialize_distributed(f"127.0.0.1:{port}", num_processes=world,
                                             process_id=rank, platform="cpu")
    assert device == torch.device("cpu")
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    out = {}
    {"pair": pair, "quad": quad}[job](inputs, out)
    torch.save(out, work / f"{job}_{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
