"""Data-parallel training of the port (one process per device,
``torch.distributed`` over gloo on the CPU) against JAX's global-batch
steps on a mesh of the conftest's virtual CPU devices.

The ranks are ``tests/torch_ddp_worker.py`` processes (torch and the port
only) at tcp://127.0.0.1:<free port>; each writes what it found to
``tmp_path`` and the test holds it against JAX in this process. JAX's
data parallelism is GSPMD over a batch-sharded global array, so its step
is the global batch's: BatchNorm statistics, every loss sum and the
gradient are taken over the whole batch. The port's 2-rank steps must
equal it at the bounds of ``tests/test_torch_accum_multistep.py`` (the seg
step in float64 at rtol 1e-9) and ``tests/test_torch_train_step.py`` (the
inpaint step in float32: terms to rtol 1e-4, parameters and statistics to
rtol 1e-3 / atol 1e-5). The two halves of the batch differ in their
statistics and mask fractions, so a run with each rank's own BatchNorm
statistics misses JAX by more than those bounds. Also: the hybrid mesh
over 4 ranks on two faked hosts, JAX's gcd narrowing of the rank mesh,
``concurrent_train2`` over 2 + 2 ranks,
the stacked super-batch's sharding, the val batches over the mesh, and a
2-rank ``torchrun`` of the seg CLI that writes one checkpoint and resumes
from it.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import jax_segmenter_variables, jax_unet_variables, one_torch_thread
from tests.test_torch_vgg import _jax_vgg
from text_segmentation_image_inpainting_tpu.losses.inpainting import (
    InpaintLossConfig as JaxLossConfig,
)
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu.parallel import mesh as jmesh
from text_segmentation_image_inpainting_tpu.train import config as jconfig
from text_segmentation_image_inpainting_tpu.train.inpaint import (
    make_inpaint_eval_step as jax_inpaint_eval,
)
from text_segmentation_image_inpainting_tpu.train.inpaint import (
    make_inpaint_train_step as jax_inpaint_step,
)
from text_segmentation_image_inpainting_tpu.train.seg import make_seg_eval_step as jax_seg_eval
from text_segmentation_image_inpainting_tpu.train.seg import make_seg_train_step as jax_seg_step
from text_segmentation_image_inpainting_tpu.train.state import create_train_state as jax_state
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import (
    inpaint_unet_state_dict,
    text_segmenter_state_dict,
    vgg16_features_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.data.pipeline import make_dataset

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_ddp_worker.py"
HW, LR, WIDTH, DEPTH, BATCH = (32, 32), 0.01, 0.35, 3, 4
VAL_SEED = 100_007


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _free_ports(n: int) -> list:
    """n distinct free ports (each socket held until all are bound)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    return env


def _start(job: str, world: int, work: Path, port: int):
    return [subprocess.Popen([sys.executable, str(WORKER), job, str(r), str(world), str(port),
                              str(work)], env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _join(procs, job: str, work: Path) -> list:
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{job} rank {r} failed:\n{out[-4000:]}"
    return [torch.load(work / f"{job}_{r}.pt", weights_only=False) for r in range(len(procs))]


def _halves_differ(rng, kind: str, dtype):
    """A batch of 4 whose halves differ: darker pages and few holes (or
    text) in the first, brighter pages and many in the second."""
    img = np.concatenate([0.5 * rng.uniform(0, 1, (2, *HW, 3)),
                          0.3 + 0.7 * rng.uniform(0, 1, (2, *HW, 3))])
    frac = np.array([0.05, 0.05, 0.4, 0.4])[:, None, None, None]
    hit = rng.random((4, *HW, 1)) < frac
    mask = (hit if kind == "seg" else ~hit).astype(np.float64)
    return {"image": img.astype(dtype), "mask": mask.astype(dtype)}


def _f64_tree(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _jax_cfg(kind):
    opt = jconfig.OptimizerConfig(kind="sgd", learning_rate=LR)
    if kind == "seg":
        return jconfig.SegTrainConfig(image_size=HW, batch_size=BATCH, width_mult=WIDTH,
                                      optimizer=opt)
    return jconfig.InpaintTrainConfig(image_size=HW, batch_size=BATCH, depth=DEPTH,
                                      loss=JaxLossConfig(vgg_dtype="float32"), optimizer=opt)


def _mesh2():
    return jmesh.make_mesh(devices=jax.devices("cpu")[:2])


def _jax_seg(variables, batch, mesh):
    """JAX's seg step in float64 on the 2-device data mesh: (state dict, metrics)."""
    with jax.enable_x64():
        model = JaxTextSegmenter(width_mult=WIDTH, dtype=jnp.float64)
        state = jax_state(_f64_tree(variables), model.apply, _jax_cfg("seg").optimizer)
        state = jax.device_put(state, jmesh.replicated(mesh))
        b = jax.device_put(_f64_tree(batch), jmesh.batch_sharding(mesh))
        state, metrics = jax.jit(jax_seg_step(model, _jax_cfg("seg")))(state, b)
        new = text_segmenter_state_dict({"params": jax.device_get(state.params),
                                         "batch_stats": jax.device_get(state.batch_stats)})
        return new, {k: float(v) for k, v in metrics.items()}


def _jax_inpaint(unet_vars, vgg_vars, batch, mesh):
    model = JaxInpaintUNet(depth=DEPTH, fuse_up=False)
    state = jax_state(unet_vars, model.apply, _jax_cfg("inpaint").optimizer)
    state = jax.device_put(state, jmesh.replicated(mesh))
    b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, jmesh.batch_sharding(mesh))
    state, terms = jax.jit(jax_inpaint_step(model, _jax_cfg("inpaint"), vgg_vars))(state, b)
    new = inpaint_unet_state_dict({"params": jax.device_get(state.params),
                                   "batch_stats": jax.device_get(state.batch_stats)})
    return new, {k: float(v) for k, v in terms.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The weights and batches; the 2-rank and 4-rank jobs, started at once
    and run while JAX computes its steps here."""
    work = tmp_path_factory.mktemp("ddp")
    seg_vars = jax_segmenter_variables(JaxTextSegmenter(width_mult=WIDTH), hw=HW, seed=61)
    unet_vars = jax_unet_variables(JaxInpaintUNet(depth=DEPTH, fuse_up=False), seed=62)
    _, vgg_vars = _jax_vgg(hw=HW, seed=63)
    rng = np.random.default_rng(64)
    seg_batch = _halves_differ(rng, "seg", np.float64)
    inp_batch = _halves_differ(rng, "inpaint", np.float32)
    singles = [_halves_differ(rng, "seg", np.float64) for _ in range(2)]
    stacked = {k: np.stack([b[k] for b in singles]) for k in singles[0]}
    torch.save({
        "seg": {k: torch.from_numpy(np.array(v)) for k, v in
                text_segmenter_state_dict(seg_vars).items()},
        "unet": {k: torch.from_numpy(np.array(v)) for k, v in
                 inpaint_unet_state_dict(unet_vars).items()},
        "vgg": {k: torch.from_numpy(np.array(v)) for k, v in
                vgg16_features_state_dict(vgg_vars).items()},
        "seg_batch": seg_batch, "inp_batch": inp_batch, "seg_stacked": stacked,
        "val_seed": VAL_SEED,
    }, work / "inputs.pt")
    ports = _free_ports(2)
    pair, quad = _start("pair", 2, work, ports[0]), _start("quad", 4, work, ports[1])
    mesh = _mesh2()
    jax_out = {"seg": _jax_seg(seg_vars, seg_batch, mesh),
               "inpaint": _jax_inpaint(unet_vars, vgg_vars, inp_batch, mesh)}
    return {"work": work, "pair": _join(pair, "pair", work), "quad": _join(quad, "quad", work),
            "jax": jax_out, "vars": (seg_vars, unet_vars, vgg_vars)}


def _seg_close(got_sd, got_m, want_sd, want_m, rtol=1e-9):
    """The f64 seg step's bound (``test_torch_accum_multistep.py::_exact``)."""
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k],
                                   rtol=1e-6 if k == "grad_norm" else rtol, err_msg=k)
    for k in want_sd:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k], rtol=rtol, atol=1e-11,
                                       err_msg=k)


def _inpaint_close(got_sd, got_m, want_sd, want_m):
    """The f32 inpaint step's bounds (``test_torch_train_step.py``)."""
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4, err_msg=k)
    for k in want_sd:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k], rtol=1e-3, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("kind", ["seg", "inpaint"])
def test_two_rank_step_is_jaxs_global_batch_step(world, kind):
    """Rank 0 and rank 1 end with the same state, equal to JAX's step on
    the 2-device mesh; the run with per-rank BatchNorm statistics misses
    it by more than the bound."""
    (sd0, m0), (sd1, m1) = (world["pair"][r][kind] for r in (0, 1))
    assert [world["pair"][r]["position"] for r in (0, 1)] == [0, 1]
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    assert m0 == m1
    want_sd, want_m = world["jax"][kind]
    close = _seg_close if kind == "seg" else _inpaint_close
    assert sorted(m0) == sorted(want_m)
    close(sd0, m0, want_sd, want_m)
    bad_sd, bad_m = world["pair"][0][f"{kind}_per_rank"]
    with pytest.raises(AssertionError):
        close(bad_sd, bad_m, want_sd, want_m)


def test_hybrid_mesh_over_two_hosts_and_its_sum(world):
    """4 ranks on two faked hosts (ranks 0, 2 and 1, 3): {dcn 2, data 2,
    model 1}, dcn-major positions, and the sum over the mesh of a global
    (4, 4) array whose row i holds i is JAX's 24.0."""
    quad = world["quad"]
    for r, out in enumerate(quad):
        assert out["shape"] == {"dcn": 2, "data": 2, "model": 1}
        assert out["ranks"] == [[[0], [2]], [[1], [3]]]
        assert out["position"] == [0, 2, 1, 3][r]
        assert out["total"] == (0.0 + 1.0 + 2.0 + 3.0) * 4


def test_make_mesh_for_batch_narrows_the_ranks_as_jax(world, capsys, cpu_devices):
    """A batch of 6 over 4 ranks: JAX's gcd narrowing, a rank mesh over
    ranks 0 and 1; ranks 2 and 3 are outside it. JAX narrows its 8 virtual
    devices the same way (gcd(8, 6) = 2)."""
    for r, out in enumerate(world["quad"]):
        assert out["narrow"] == ([0, 1], [0, 1, None, None][r])
    assert dict(jmesh.make_mesh_for_batch(6).shape) == {"data": 2, "model": 1}
    assert "using 2-way DP over the first 2 devices" in capsys.readouterr().out


def test_concurrent_train2_equals_each_group_alone(world):
    """Ranks 0-1 train the segmenter, ranks 2-3 the U-Net, at once: each
    group's result is its 2-rank step run alone, bit for bit, and so
    JAX's (the test above)."""
    quad, pair = world["quad"], world["pair"]
    assert quad[0]["groups"] == ([0, 1], [2, 3])
    for r, kind in ((0, "seg"), (1, "seg"), (2, "inpaint"), (3, "inpaint")):
        (sd, m), (want_sd, want_m) = quad[r][kind], pair[0][kind]
        assert m == want_m, (r, kind)
        for k in want_sd:
            assert torch.equal(sd[k], want_sd[k]), (r, kind, k)


def test_stacked_batch_sharding_multi_step_equals_single_steps(world):
    """k = 2 seg steps as one multi-step over this rank's columns of the
    (2, 4, ...) super-batch (the same columns as ``DevicePrefetcher``
    with that sharding yields) equal the two steps run one by one over
    ``batch_sharding``: the same state bit for bit, the same metrics."""
    stacked = torch.load(world["work"] / "inputs.pt", weights_only=False)["seg_stacked"]
    for r in (0, 1):
        out = world["pair"][r]
        cols = out["stacked_cols"]
        (fetched,) = out["prefetched"]
        for k, v in stacked.items():
            assert cols[k].shape == (2, 2, *v.shape[2:])
            np.testing.assert_array_equal(cols[k].numpy(), v[:, 2 * r:2 * r + 2])
            np.testing.assert_array_equal(fetched[k].numpy(), v[:, 2 * r:2 * r + 2])
        (sd, m), (want_sd, want_m) = out["multi"], out["singles"]
        for k in want_sd:
            assert torch.equal(sd[k], want_sd[k]), k
        assert m == {k: [step[k] for step in want_m] for k in m}


def test_val_batches_over_the_mesh_score_what_jax_scores(world):
    """Each rank's val batch is its rows of the single-process batch, and
    the eval steps over the mesh report, on every rank, what JAX's eval
    steps score on that global batch sharded over its 2-device mesh."""
    seg_vars, unet_vars, _ = world["vars"]
    pair = world["pair"]
    want_batches = []
    for kind in ("seg", "inpaint"):
        it = make_dataset(kind, batch_size=BATCH, size=HW, seed=VAL_SEED)
        want_batches.append({k: np.asarray(v, np.float32) for k, v in next(it).items()})
    for r in (0, 1):
        for i, want in enumerate(want_batches):
            (got,) = pair[r]["val_batches"][i]
            for k, v in want.items():
                np.testing.assert_array_equal(got[k].numpy(), v[2 * r:2 * r + 2])
    assert pair[0]["val_seg"] == pair[1]["val_seg"]
    assert pair[0]["val_inpaint"] == pair[1]["val_inpaint"]
    mesh = _mesh2()
    with jax.enable_x64():
        model = JaxTextSegmenter(width_mult=WIDTH, dtype=jnp.float64)
        state = jax_state(_f64_tree(seg_vars), model.apply, _jax_cfg("seg").optimizer)
        b = jax.device_put(_f64_tree(want_batches[0]), jmesh.batch_sharding(mesh))
        want_seg = {f"val_{k}": float(v) for k, v in jax.jit(jax_seg_eval(model))(state, b).items()}
    model = JaxInpaintUNet(depth=DEPTH, fuse_up=False)
    state = jax_state(unet_vars, model.apply, _jax_cfg("inpaint").optimizer)
    b = jax.device_put({k: jnp.asarray(v) for k, v in want_batches[1].items()},
                       jmesh.batch_sharding(mesh))
    want_inp = {f"val_{k}": float(v) for k, v in jax.jit(jax_inpaint_eval(model))(state, b).items()}
    for got, want in ((pair[0]["val_seg"], want_seg), (pair[0]["val_inpaint"], want_inp)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def _torchrun(args, cwd: Path) -> str:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node",
           "2", "--master-addr", "127.0.0.1", "--master-port", str(_free_ports(1)[0]), "-m",
           "text_segmentation_image_inpainting_tpu_torch.train.run_seg", *args]
    proc = subprocess.run(cmd, cwd=cwd, env=_env(), capture_output=True, text=True, timeout=240)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    return out


def test_two_rank_cli_writes_one_checkpoint_that_resumes(tmp_path):
    """``torchrun --nproc-per-node 2`` of run_seg: 2 steps write one
    checkpoint (rank 0 only, as the log); a second 2-rank run to 4 steps
    restores it on both ranks and goes on from step 2."""
    common = ["--batch-size", "4", "--image-size", "32", "--width-mult", "0.35", "--log-every",
              "1", "--ckpt-every", "2", "--val-batches", "1", "--device", "cpu", "--ckpt-dir",
              str(tmp_path / "ck")]
    _torchrun(["--steps", "2", *common], tmp_path)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_2.pt"]
    out = _torchrun(["--steps", "4", *common], tmp_path)
    assert out.count("resumed from step 2") == 2
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_2.pt", "step_4.pt"]
    records = [json.loads(line) for line in open(tmp_path / "logs" / "seg.jsonl")]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    assert torch.load(tmp_path / "ck" / "step_4.pt", weights_only=True)["step"] == 4
