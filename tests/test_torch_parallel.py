"""The port's multi-device serving against the JAX package, on the CPU.

The H-sharded ops (``parallel/spatial.py``), the two-stage pipeline
(``parallel/stage_pipeline.py``), the mesh helpers (``parallel/mesh.py``)
and the data-parallel server and prefetcher (``mesh=``), on meshes whose
entries repeat the CPU, as JAX's tests use its virtual CPU devices.
Inputs come from a numpy seed and JAX weights are carried into the port
by ``compat/from_jax.py``. Each sharded result is held to JAX's
*unsharded* function (JAX's own tests hold its sharded functions to the
unsharded ones) at rtol and atol 1e-5 in f32, masks equal bit for bit.
"""

import contextlib
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import one_torch_thread, port_segmenter, port_unet
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu.ops.conv import conv2d as jax_conv2d
from text_segmentation_image_inpainting_tpu.ops.partial_conv import (
    partial_conv2d as jax_partial_conv2d,
)
from text_segmentation_image_inpainting_tpu.parallel import mesh as jax_mesh
from text_segmentation_image_inpainting_tpu.parallel.stage_pipeline import (
    pipeline2_throughput_model as jax_throughput_model,
)
from text_segmentation_image_inpainting_tpu.pipeline import end_to_end as jpipe
from text_segmentation_image_inpainting_tpu_torch.data.pipeline import DevicePrefetcher
from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import (
    partial_conv2d,
    spatial_axis,
)
from text_segmentation_image_inpainting_tpu_torch.parallel import (
    batch_sharding,
    gather,
    make_mesh,
    make_mesh_for_batch,
    make_stage_mesh,
    pipeline2_run,
    pipeline2_throughput_model,
    shard_batch,
    spatial_conv2d,
    spatial_inpaint_unet,
    spatial_partial_conv2d,
    stacked_batch_sharding,
)
from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import distinct_devices
from text_segmentation_image_inpainting_tpu_torch.parallel.spatial import run_bands
from text_segmentation_image_inpainting_tpu_torch.pipeline import (
    PageStreamServer,
    TextRemovalPipeline,
)
from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import to_compute
from text_segmentation_image_inpainting_tpu_torch.pipeline.sparse import to_uint8

TOL = dict(rtol=1e-5, atol=1e-5)
SIZE = 32  # serving pages, as tests/test_torch_serve.py
TILE = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def oihw(kernel_hwio) -> torch.Tensor:
    return t(kernel_hwio).permute(3, 2, 0, 1).contiguous()


# -- the spatial leaf ops ------------------------------------------------------

def test_spatial_partial_conv_matches_jax(rng):
    """JAX's test_spatial_partial_conv_matches_single_device: 8 bands of 8
    rows, two mask groups (2, 4), against JAX's unsharded op."""
    x = rng.standard_normal((1, 64, 16, 6)).astype(np.float32)
    m = (rng.random((1, 64, 16, 2)) > 0.4).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 4)).astype(np.float32) * 0.2
    b = rng.standard_normal((4,)).astype(np.float32)
    want_y, want_m = jax_partial_conv2d(jnp.asarray(x), jnp.asarray(m), jnp.asarray(w),
                                        jnp.asarray(b), group_sizes=(2, 4), padding=1)
    got_y, got_m = spatial_partial_conv2d(make_mesh(8, platform="cpu"), t(x), t(m), oihw(w),
                                          t(b), group_sizes=(2, 4))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_spatial_conv_matches_jax(rng):
    x = rng.standard_normal((1, 64, 16, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 7)).astype(np.float32) * 0.2
    b = rng.standard_normal((7,)).astype(np.float32)
    want = jax_conv2d(jnp.asarray(x), jnp.asarray(w), stride=1, padding=1, bias=jnp.asarray(b))
    got = spatial_conv2d(make_mesh(8, platform="cpu"), t(x), oihw(w), t(b))
    assert got.shape == (1, 64, 16, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_spatial_stride2_partial_conv_through_the_context(rng, k):
    """A stride-2 partial conv (the encoder's) under ``spatial_axis``: halo
    p rows above, p - 1 below, H padding 0; equal to JAX's unsharded op."""
    x = rng.standard_normal((1, 64, 16, 6)).astype(np.float32)
    m = (rng.random((1, 64, 16, 1)) > 0.4).astype(np.float32)
    w = rng.standard_normal((k, k, 6, 4)).astype(np.float32) * 0.2
    want_y, want_m = jax_partial_conv2d(jnp.asarray(x), jnp.asarray(m), jnp.asarray(w),
                                        stride=2, padding=k // 2)

    def local(ring, xb, mb):
        with spatial_axis(ring):
            return partial_conv2d(xb, mb, oihw(w), stride=2, padding=k // 2)

    got_y, got_m = run_bands(make_mesh(8, platform="cpu"), local, (t(x), t(m)))
    assert got_y.shape == (1, 32, 8, 4)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_spatial_context_checks_the_geometry(rng):
    """Torch-same H padding only, and the local H divisible by the stride."""
    mesh = make_mesh(2, platform="cpu")
    x, m = torch.ones((1, 8, 8, 2)), torch.ones((1, 8, 8, 1))
    w = torch.ones((2, 2, 3, 3))

    def local(pad, stride):
        def fn(ring, xb, mb):
            with spatial_axis(ring):
                return partial_conv2d(xb, mb, w, stride=stride, padding=pad)
        return fn

    with pytest.raises(ValueError, match="torch-same H padding"):
        run_bands(mesh, local(0, 1), (x, m))
    with pytest.raises(ValueError, match="divisible by the stride"):
        run_bands(mesh, local(1, 2), (torch.ones((1, 6, 8, 2)), torch.ones((1, 6, 8, 1))))


@contextlib.contextmanager
def short_switch_interval():
    """Thread switches every microsecond, so a race shows."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(interval)


def test_bands_under_fast_thread_switches(rng):
    """16 bands (more host threads than cores) taking turns, the thread
    switched every microsecond, 3 rounds: every result equals the
    unsharded conv."""
    from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d

    x = torch.from_numpy(rng.standard_normal((2, 64, 8, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 4, 3, 3)).astype(np.float32))
    want = conv2d(x, w, padding=1)
    with short_switch_interval():
        for _ in range(3):
            got = spatial_conv2d(make_mesh(16, platform="cpu"), x, w)
            torch.testing.assert_close(got, want, **TOL)


def test_launch_counters_lose_no_count_under_threads():
    """The bands' threads bump the kernels' launch counters: 16 threads,
    2000 bumps each, switched every microsecond; every bump is counted."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    before = kpc.K1_LAUNCHES
    try:
        with short_switch_interval():
            threads = [threading.Thread(target=lambda: [kpc._count("K1_LAUNCHES")
                                                        for _ in range(2000)])
                       for _ in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert kpc.K1_LAUNCHES - before == 16 * 2000
    finally:
        kpc.K1_LAUNCHES = before


# -- the H-sharded U-Net ---------------------------------------------------------

@pytest.fixture(scope="module")
def unet_pair():
    """JAX's test_spatial_inpaint_unet_matches_single_device configuration:
    a depth-3 literal U-Net with JAX's own init, on a (1, 64, 32, 3) page
    with a quarter of holes, drawn from seed 0 in JAX's order."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 32, 3)).astype(np.float32)
    m = (rng.random((1, 64, 32, 1)) > 0.25).astype(np.float32)
    jax_unet = JaxInpaintUNet(depth=3, fuse_up=False)
    variables = jax.jit(jax_unet.init)(jax.random.key(0), jnp.asarray(x * m), jnp.asarray(m))
    return jax_unet, variables, port_unet(variables, depth=3), (x * m, m)


def test_spatial_inpaint_unet_matches_jax(unet_pair):
    """The unmodified forward over 8 bands of 8 rows against JAX's
    unsharded ``unet.apply``."""
    jax_unet, variables, unet, (x, m) = unet_pair
    want = np.asarray(jax_unet.apply(variables, jnp.asarray(x), jnp.asarray(m)))
    got = spatial_inpaint_unet(make_mesh(8, platform="cpu"), unet, t(x), t(m))
    assert got.shape == (1, 64, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not unet.training


def test_spatial_inpaint_unet_restores_the_training_mode(rng, unet_pair):
    """The bands run in eval mode; the caller's mode comes back."""
    unet = unet_pair[2]
    x = torch.from_numpy(rng.standard_normal((1, 16, 8, 3)).astype(np.float32))
    unet.train()
    try:
        got = spatial_inpaint_unet(make_mesh(2, platform="cpu"), unet, x, torch.ones((1, 16, 8, 1)))
        assert unet.training
        unet.eval()
        with torch.no_grad():
            want = unet(x, torch.ones((1, 16, 8, 1)))
        torch.testing.assert_close(got, want, **TOL)
    finally:
        unet.eval()


def test_spatial_inpaint_unet_rejects_an_indivisible_local_h(unet_pair):
    unet = unet_pair[2]
    x, m = torch.zeros((1, 64, 32, 3)), torch.ones((1, 64, 32, 1))
    with pytest.raises(ValueError, match=r"local H 64/16 must be divisible by 2\*\*depth=8"):
        spatial_inpaint_unet(make_mesh(16, platform="cpu"), unet, x, m)


def test_a_band_that_raises_fails_the_call_quickly(unet_pair):
    """One band raises in its second encoder layer: the ring is broken,
    the other bands stop where they wait for their turn, and the call
    raises the band's own error within seconds (not after the turn's
    timeout)."""
    unet = unet_pair[2]
    conv = unet.enc_convs[1]
    forward = conv.forward

    def failing(*args, **kwargs):
        from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import (
            _active_spatial_axis,
        )

        if _active_spatial_axis().rank == 2:
            raise RuntimeError("band 2 failed")
        return forward(*args, **kwargs)

    conv.forward = failing
    try:
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="band 2 failed"):
            spatial_inpaint_unet(make_mesh(4, platform="cpu"), unet, torch.zeros((1, 32, 16, 3)),
                                 torch.ones((1, 32, 16, 1)))
        assert time.perf_counter() - t0 < 5.0
    finally:
        del conv.forward
    # every band has returned: the host threads take the next call
    got = spatial_inpaint_unet(make_mesh(4, platform="cpu"), unet, torch.zeros((1, 32, 16, 3)),
                               torch.ones((1, 32, 16, 1)))
    assert got.shape == (1, 32, 16, 3)


# -- the two-stage pipeline --------------------------------------------------------

def test_pipeline2_matches_jax_fused_run(rng):
    """JAX's test_pipeline2_matches_fused_run configuration (width 0.35,
    depth 3, 32^2, T 3, N 2, f32, JAX's init) on a (cpu, cpu) stage mesh,
    against ``jax.jit(pipe.run)`` per microbatch."""
    jax_pipe = jpipe.TextRemovalPipeline(
        seg=JaxTextSegmenter(width_mult=0.35, dtype=jnp.float32),
        unet=JaxInpaintUNet(depth=3, dtype=jnp.float32),
        compute_dtype=jnp.float32, dilate_radius=1,
    )
    seg_vars, unet_vars = jax_pipe.init_variables(jax.random.key(0), page_hw=(SIZE, SIZE))
    pipe = TextRemovalPipeline(port_segmenter(seg_vars, width_mult=0.35),
                               port_unet(unet_vars, depth=3), compute_dtype=torch.float32,
                               dilate_radius=1).eval()
    pages_mb = rng.random((3, 2, SIZE, SIZE, 3), dtype=np.float32)
    got = pipeline2_run(make_stage_mesh(["cpu", "cpu"]), pipe, t(pages_mb))
    assert got.shape == pages_mb.shape and got.dtype == torch.float32
    run = jax.jit(jax_pipe.run)
    for i in range(pages_mb.shape[0]):
        want_clean, _ = run(seg_vars, unet_vars, jnp.asarray(pages_mb[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want_clean), **TOL,
                                   err_msg=f"microbatch {i}")
        np.testing.assert_array_equal(got[i].numpy(), pipe.run(t(pages_mb[i]))[0].numpy())


@pytest.mark.parametrize("t_seg,t_inpaint,t_mb", [(1.0, 1.0, 8), (1.0, 3.0, 4), (0.04, 0.11, 1)])
def test_pipeline2_throughput_model_equals_jax(t_seg, t_inpaint, t_mb):
    assert pipeline2_throughput_model(t_seg, t_inpaint, t_mb) == jax_throughput_model(
        t_seg, t_inpaint, t_mb)


def test_stage_mesh_needs_two_devices():
    with pytest.raises(ValueError, match="2 devices"):
        make_stage_mesh(["cpu"])
    assert make_stage_mesh(["cpu", "cpu"]).shape == {"stage": 2}


# -- the mesh ------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [2, 6, 8])
def test_make_mesh_for_batch_narrows_as_jax(batch, capsys, cpu_devices):
    """gcd(8, batch) data entries, with JAX's note when it narrows."""
    want = jax_mesh.make_mesh_for_batch(batch)
    want_note = capsys.readouterr().out
    got = make_mesh_for_batch(batch, devices=["cpu"] * len(cpu_devices))
    assert got.shape == dict(want.shape) == {"data": np.gcd(8, batch), "model": 1}
    assert capsys.readouterr().out == want_note


def test_make_mesh_repeats_a_device_only_when_asked():
    assert make_mesh(4, platform="cpu").device_list == [torch.device("cpu")] * 4
    assert make_mesh(platform="cpu").shape == {"data": 1, "model": 1}
    assert make_mesh(devices=["cpu", "cpu"], n_devices=1).shape["data"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_an_index_less_cuda_entry_is_the_current_device(monkeypatch):
    """``"cuda"`` and ``"cuda:0"`` name one card when it is the current
    one: one distinct device, one entry in a stage mesh, so ``replicate``
    keeps the module (without a card: the current device is faked)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = make_mesh(devices=["cuda", "cuda:0"])
    assert mesh.device_list == [torch.device("cuda", 0)] * 2
    assert distinct_devices(mesh) == [torch.device("cuda", 0)]
    assert make_stage_mesh(["cuda", "cuda:0"]).devices == (torch.device("cuda", 0),) * 2
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert distinct_devices(make_mesh(devices=["cuda", "cuda:0"])) == [
        torch.device("cuda", 1), torch.device("cuda", 0)]


def test_batch_shardings_cut_the_batch_axis_in_entry_order(rng):
    """``batch_sharding`` cuts the leading axis, ``stacked_batch_sharding``
    the second of a (k, batch, ...) super-batch; ``shard_batch`` over a
    device mesh follows either."""
    mesh = make_mesh(2, platform="cpu")
    stacked = rng.integers(0, 256, (3, 4, 2, 2, 3), dtype=np.uint8)
    parts = shard_batch(mesh, {"image": stacked}, stacked_batch_sharding(mesh))
    for i, part in enumerate(parts):
        np.testing.assert_array_equal(part["image"].numpy(), stacked[:, 2 * i:2 * i + 2])
    assert batch_sharding(mesh).local(stacked[0], 1).shape == (2, 2, 2, 3)
    assert stacked_batch_sharding(mesh).local_shape((3, 4, 2)) == (3, 2, 2)
    with pytest.raises(ValueError, match="does not split"):
        stacked_batch_sharding(mesh).local(stacked[:, :3], 0)


def test_shard_batch_and_gather_keep_page_order(rng):
    mesh = make_mesh(4, platform="cpu")
    pages = rng.integers(0, 256, (8, 4, 4, 3), dtype=np.uint8)
    parts = shard_batch(mesh, {"image": pages})
    assert [p["image"].shape[0] for p in parts] == [2, 2, 2, 2]
    np.testing.assert_array_equal(gather([p["image"] for p in parts]).numpy(), pages)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, pages[:6])


def test_prefetcher_over_a_mesh_yields_one_part_per_entry(rng):
    batches = [{"image": rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)} for _ in range(3)]
    pf = DevicePrefetcher(iter(batches), mesh=make_mesh(2, platform="cpu"))
    try:
        got = list(pf)
    finally:
        pf.close()
    assert len(got) == 3
    for want, parts in zip(batches, got):
        assert len(parts) == 2
        np.testing.assert_array_equal(
            np.concatenate([p["image"].numpy() for p in parts]), want["image"])


# -- the data-parallel server ---------------------------------------------------------

@pytest.fixture(scope="module")
def pipe():
    from text_segmentation_image_inpainting_tpu_torch.models import TextSegmenter

    return TextRemovalPipeline(
        TextSegmenter(width_mult=0.35, dtype=torch.float32), InpaintUNet(depth=3),
        compute_dtype=torch.float32, dilate_radius=1,
    ).init_weights(torch.Generator().manual_seed(0)).eval()


def direct_halves(pipe, pages):
    """The port's ``run`` on each half of the batch, as uint8."""
    outs = [pipe.run(to_compute(torch.from_numpy(h), pipe.compute_dtype))
            for h in np.split(pages, 2)]
    return (np.concatenate([to_uint8(c).numpy() for c, _ in outs]),
            np.concatenate([m.to(torch.uint8).numpy() for _, m in outs]))


@pytest.mark.parametrize("mode", ["serve", "chunked", "sparse"])
def test_dp_server_equals_run_per_shard(pipe, rng, mode):
    """A 2-entry mesh: ``serve()`` (depth 2), chunk-2 ``submit``/``collect``
    with a flushed tail, and the changed-tile wire; each batch equal to the
    port's ``run`` on its halves (the sparse wire in the changed tiles,
    the input bytes elsewhere)."""
    mesh = make_mesh(2, platform="cpu")
    batches = [rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(5)]
    if mode == "serve":
        got = list(PageStreamServer(pipe, depth=2, mesh=mesh).serve(iter(batches)))
    elif mode == "chunked":
        server = PageStreamServer(pipe, depth=1, chunk=2, mesh=mesh)
        for b in batches:
            server.submit(b)
        got = list(server.drain())
    else:
        server = PageStreamServer(pipe, depth=2, sparse_tiles=4, tile=TILE, mesh=mesh)
        got = list(server.serve(iter(batches)))
    assert len(got) == len(batches)
    for pages, (clean, mask) in zip(batches, got):
        want_clean, want_mask = direct_halves(pipe, pages)
        np.testing.assert_array_equal(mask, want_mask)
        if mode == "sparse":
            tiles = mask[..., 0].reshape(4, 2, TILE, 2, TILE).max(axis=(2, 4)) > 0
            region = np.kron(tiles, np.ones((TILE, TILE), bool))[..., None]
            np.testing.assert_array_equal(np.where(region, want_clean, pages), clean)
        else:
            np.testing.assert_array_equal(clean, want_clean)


def test_dp_server_close_to_jax_run_on_the_whole_batch():
    """The 2-entry server on JAX's small_pipe weights against
    ``jax.jit(pipe.run)`` on each whole batch: masks equal away from
    logits within 1e-4 of the threshold, clean pages within 1 (f32
    summation order)."""
    from text_segmentation_image_inpainting_tpu_torch.ops.morphology import dilate_mask

    jax_pipe = jpipe.TextRemovalPipeline(
        seg=JaxTextSegmenter(width_mult=0.35, dtype=jnp.float32),
        unet=JaxInpaintUNet(depth=3, dtype=jnp.float32),
        compute_dtype=jnp.float32, dilate_radius=1,
    )
    seg_vars, unet_vars = jax_pipe.init_variables(jax.random.key(0), page_hw=(SIZE, SIZE))
    port = TextRemovalPipeline(port_segmenter(seg_vars, width_mult=0.35),
                               port_unet(unet_vars, depth=3), compute_dtype=torch.float32,
                               dilate_radius=1).eval()
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(2)]
    got = list(PageStreamServer(port, depth=2, mesh=make_mesh(2, platform="cpu")).serve(
        iter(batches)))
    run = jax.jit(jax_pipe.run)
    text = 0
    for pages, (clean_u8, mask_u8) in zip(batches, got):
        x = jnp.asarray(pages, jnp.float32) * (1.0 / 255.0)
        want_clean, want_mask = run(seg_vars, unet_vars, x)
        want_u8 = np.round(np.clip(np.asarray(want_clean), 0, 1) * 255).astype(np.uint8)
        logits = np.asarray(jax_pipe.seg.apply(seg_vars, x))[..., 0]
        near = torch.from_numpy((np.abs(logits) < 1e-4).astype(np.float32))
        near = dilate_mask(near, 1).numpy()[..., None] > 0
        diff = mask_u8 != np.asarray(want_mask).astype(np.uint8)
        assert not (diff & ~near).any(), f"{int(diff.sum())} mask pixels differ"
        keep = np.broadcast_to(~near, pages.shape)
        assert np.abs(clean_u8.astype(int) - want_u8.astype(int))[keep].max() <= 1
        text += int(mask_u8.sum())
    assert text > 0


def test_dp_server_rejects_a_batch_that_does_not_split(pipe, rng):
    server = PageStreamServer(pipe, mesh=make_mesh(2, platform="cpu"))
    with pytest.raises(ValueError, match="does not split"):
        server.submit(rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8))
