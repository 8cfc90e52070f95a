"""The port's page server, its prefetcher and its serving pages, on the CPU.

``PageStreamServer`` is held to the port's own dense path (``pipe.run``
with the same uint8 conversion) in the cases of tests/test_sparse_serve.py
and of tests/test_train_and_pipeline.py's server tests, bit for bit: the
port needs no jit, so none of these is slow. The small pipeline is JAX's
``small_pipe`` (32x32 pages, tile 16 = 4 tiles a page, a width-0.35
segmenter, a depth-3 U-Net, f32, dilation 1) with the port's random
weights from seed 0, which put text in 1-2 of the 4 tiles of each page
(checked), so every sparse case has changed and unchanged tiles.

One server run is held to ``jax.jit(pipe.run)`` on JAX's own small_pipe
(its weights carried over by ``compat/from_jax.py``): masks equal except
within the dilation radius of a pixel whose JAX logit lies within 1e-4
of the threshold (tests/test_torch_pipeline.py's ``_near_threshold``),
clean uint8 pages within 1 (f32 summation order).

Also: the threshold in the logits' dtype (bit-equal masks to JAX's at
0.5 and 0.3, bf16 and f32, around the rounded threshold), the
prefetcher's contract, and ``make_page_stream_u8`` (bit-equal to JAX's;
it needs no PIL).
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from tests.test_torch_bridge import (  # noqa: F401 (jax_native_engines: a fixture)
    jax_native_engines,
    one_torch_thread,
    port_segmenter,
    port_unet,
)
from text_segmentation_image_inpainting_tpu.data.pipeline import (
    make_page_stream_u8 as jax_page_stream_u8,
)
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu.pipeline import end_to_end as jpipe
from text_segmentation_image_inpainting_tpu_torch.data import native_pages
from text_segmentation_image_inpainting_tpu_torch.data.pipeline import (
    DevicePrefetcher,
    make_page_stream_u8,
)
from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, TextSegmenter
from text_segmentation_image_inpainting_tpu_torch.ops.morphology import dilate_mask
from text_segmentation_image_inpainting_tpu_torch.pipeline import (
    PageStreamServer,
    TextRemovalPipeline,
)
from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import to_compute
from text_segmentation_image_inpainting_tpu_torch.pipeline.sparse import to_uint8

REPO = Path(__file__).resolve().parents[1]
SIZE = 32
TILE = 16  # 2x2 = 4 tiles a page


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def pipe():
    return TextRemovalPipeline(
        TextSegmenter(width_mult=0.35, dtype=torch.float32), InpaintUNet(depth=3),
        compute_dtype=torch.float32, dilate_radius=1,
    ).init_weights(torch.Generator().manual_seed(0)).eval()


def u8_batches(rng, count, n=2):
    return [rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(count)]


def direct(pipe, pages):
    """The port's dense path on ``pages``, as uint8: what the server returns."""
    clean, mask = pipe.run(to_compute(torch.from_numpy(pages), pipe.compute_dtype))
    return to_uint8(clean).numpy(), mask.to(torch.uint8).numpy()


def changed_tiles(mask_u8):
    """(N, 2, 2) bool: which tiles of each page the mask touches."""
    n = mask_u8.shape[0]
    return mask_u8[..., 0].reshape(n, 2, TILE, 2, TILE).max(axis=(2, 4)) > 0


def assert_sparse_matches(pages, dense, sparse):
    """Masks equal; clean equal to dense inside changed tiles and equal to
    the input bytes outside them."""
    (dc, dm), (sc, sm) = dense, sparse
    np.testing.assert_array_equal(sm, dm)
    region = np.kron(changed_tiles(dm), np.ones((TILE, TILE))).astype(bool)
    np.testing.assert_array_equal(sc[region], dc[region])
    np.testing.assert_array_equal(sc[~region], pages[~region])


def test_small_pipe_touches_some_tiles_not_all(pipe, rng):
    flags = np.concatenate([changed_tiles(direct(pipe, b)[1]) for b in u8_batches(rng, 4)])
    counts = flags.sum(axis=(1, 2))
    assert counts.min() >= 1 and counts.max() < 4 and (counts > 1).any(), counts


# -- tests/test_sparse_serve.py ----------------------------------------------

def test_sparse_server_matches_dense(pipe, rng):
    batches = u8_batches(rng, 4)
    dense = list(PageStreamServer(pipe, depth=2).serve(iter(batches)))
    server = PageStreamServer(pipe, depth=2, sparse_tiles=4, tile=TILE)
    sparse = list(server.serve(iter(batches)))
    assert len(dense) == len(sparse) == 4
    for pages, d, s in zip(batches, dense, sparse):
        assert_sparse_matches(pages, d, s)
        np.testing.assert_array_equal(d[0], direct(pipe, pages)[0])
    assert server.wire_bytes == 4 * 2 * (4 * TILE * TILE * 3 + 4 * TILE * TILE // 8 + 4 * 4 + 4)


def test_sparse_server_overflow_falls_back_dense(pipe, rng):
    """A 1-tile budget: pages with more than 1 changed tile equal the dense
    path (redone densely), the others come back sparse."""
    batches = u8_batches(rng, 2)
    dense = list(PageStreamServer(pipe).serve(iter(batches)))
    sparse = list(PageStreamServer(pipe, sparse_tiles=1, tile=TILE).serve(iter(batches)))
    overflowed = 0
    for pages, (dc, dm), (sc, sm) in zip(batches, dense, sparse):
        assert_sparse_matches(pages, (dc, dm), (sc, sm))
        for i in range(dm.shape[0]):
            if changed_tiles(dm)[i].sum() > 1:
                overflowed += 1
                np.testing.assert_array_equal(sc[i], dc[i])
                np.testing.assert_array_equal(sm[i], dm[i])
    assert overflowed > 0


def test_submit_chunked_matches_per_batch(pipe, rng):
    """chunk=2: 5 submits -> 2 stacked dispatches and a flushed tail;
    results equal the unchunked server's, in order."""
    batches = u8_batches(rng, 5)
    plain = PageStreamServer(pipe)
    for b in batches:
        plain.submit(b)
    want = list(plain.drain())
    chunked = PageStreamServer(pipe, chunk=2)
    for b in batches:
        chunked.submit(b)
    assert len(chunked._inflight) == 2  # 2 full chunks dispatched, 1 pending
    got = list(chunked.drain())
    assert len(got) == len(want) == 5
    for (wc, wm), (gc, gm) in zip(want, got):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gm, wm)


def test_submit_chunked_sparse(pipe, rng):
    batches = u8_batches(rng, 3)
    server = PageStreamServer(pipe, chunk=2, sparse_tiles=4, tile=TILE)
    for b in batches:
        server.submit(b)
    got = list(server.drain())
    assert len(got) == 3
    for pages, s in zip(batches, got):
        assert_sparse_matches(pages, direct(pipe, pages), s)


def test_sparse_budget_larger_than_page_tile_count(pipe, rng):
    """A budget of 9 on pages of 4 tiles: the slots are clamped to 4 on
    both sides of the wire."""
    batches = u8_batches(rng, 2)
    server = PageStreamServer(pipe, sparse_tiles=9, tile=TILE)
    for pages, s in zip(batches, server.serve(iter(batches))):
        assert_sparse_matches(pages, direct(pipe, pages), s)


def test_sparse_server_rejects_unpackable_tile(pipe):
    with pytest.raises(ValueError, match="tile % 8"):
        PageStreamServer(pipe, sparse_tiles=4, tile=20)
    with pytest.raises(ValueError, match="output_uint8"):
        PageStreamServer(pipe, sparse_tiles=4, output_uint8=False)


def test_adaptive_budget_policy(pipe):
    """Power-of-two levels, 25% headroom over the last 8 batches, capped."""
    server = PageStreamServer(pipe, sparse_tiles=96, tile=TILE)
    assert server._k_levels == [16, 32, 64, 96]
    assert server._k_next == 96  # the first dispatch is safe
    server._observe_counts(np.array([3, 10]))
    assert server._k_next == 16  # 10 * 1.25 + 1 = 13 -> 16
    server._observe_counts(np.array([40]))
    assert server._k_next == 64  # 40 * 1.25 + 1 = 51 -> 64
    server._observe_counts(np.array([200]))
    assert server._k_next == 96  # above the cap: the cap
    for _ in range(8):  # the busy batches age out of the window
        server._observe_counts(np.array([2]))
    assert server._k_next == 16


def test_sparse_adaptive_undershoot_retries_and_matches_dense(pipe, rng):
    """A forced budget of 1 on multi-tile pages retries at the largest
    budget on the sparse wire (one more buffer read back) and matches."""
    batches = u8_batches(rng, 3)
    server = PageStreamServer(pipe, sparse_tiles=4, tile=TILE)
    server._k_next = 1
    got = list(server.serve(iter(batches)))
    first_k1 = 2 * (TILE * TILE * 3 + TILE * TILE // 8 + 4 + 4)
    per_k4 = 2 * (4 * TILE * TILE * 3 + 4 * TILE * TILE // 8 + 4 * 4 + 4)
    assert server.wire_bytes > first_k1 + 2 * per_k4  # the retry shipped too
    for pages, s in zip(batches, got):
        assert_sparse_matches(pages, direct(pipe, pages), s)


# -- tests/test_train_and_pipeline.py's server tests ---------------------------

def test_page_stream_server_matches_direct_run(pipe, rng):
    """Float pages, depth 2: the served uint8 pages and masks equal
    ``pipe.run``'s, in order."""
    batches = [rng.random((2, SIZE, SIZE, 3), dtype=np.float32) for _ in range(5)]
    got = list(PageStreamServer(pipe, depth=2).serve(iter(batches)))
    assert len(got) == 5
    for pages, (clean_u8, mask_u8) in zip(batches, got):
        want_clean, want_mask = pipe.run(torch.from_numpy(pages))
        assert clean_u8.dtype == np.uint8 and clean_u8.shape == pages.shape
        np.testing.assert_array_equal(clean_u8, to_uint8(want_clean).numpy())
        np.testing.assert_array_equal(mask_u8, want_mask.numpy().astype(np.uint8))


def test_page_stream_server_submit_collect(pipe, rng):
    server = PageStreamServer(pipe, depth=1, output_uint8=False)
    assert server.collect() is None and not server.ready()
    a = rng.random((1, SIZE, SIZE, 3), dtype=np.float32)
    b = rng.random((1, SIZE, SIZE, 3), dtype=np.float32)
    server.submit(a)
    assert not server.ready()  # depth 1: one in flight, keep pipelining
    server.submit(b)
    assert server.ready()
    outs = list(server.drain())
    assert len(outs) == 2 and not server.ready()
    for pages, (clean, mask) in zip((a, b), outs):
        want_clean, want_mask = pipe.run(torch.from_numpy(pages))
        np.testing.assert_array_equal(clean, want_clean.numpy())
        np.testing.assert_array_equal(mask, want_mask.numpy())


def test_page_stream_server_float_output_of_a_bf16_pipe(rng):
    """output_uint8=False on the default bf16 pipeline: the results come
    back as float32 holding the bf16 values of run, through serve() and
    submit/collect."""
    bf16 = TextRemovalPipeline(
        TextSegmenter(width_mult=0.35), InpaintUNet(depth=3), dilate_radius=1,
    ).init_weights(torch.Generator().manual_seed(0)).eval()
    assert bf16.compute_dtype == torch.bfloat16
    batches = u8_batches(rng, 3)
    server = PageStreamServer(bf16, depth=1, output_uint8=False)
    served = list(server.serve(iter(batches)))
    server.submit(batches[0])
    served.append(server.collect())
    assert len(served) == 4
    for pages, (clean, mask) in zip(batches + batches[:1], served):
        want_clean, want_mask = bf16.run(to_compute(torch.from_numpy(pages), torch.bfloat16))
        assert clean.dtype == mask.dtype == np.float32
        np.testing.assert_array_equal(clean, want_clean.float().numpy())
        np.testing.assert_array_equal(mask, want_mask.float().numpy())


def test_page_stream_server_uint8_ingest(pipe, rng):
    """uint8 pages are the float pages times 1/255 in the compute dtype."""
    u8 = (rng.random((2, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    server = PageStreamServer(pipe, depth=1)
    server.submit(u8)
    clean_u8, _ = server.collect()
    want, _ = pipe.run(torch.from_numpy(u8).float() * np.float32(1.0 / 255.0))
    np.testing.assert_array_equal(clean_u8, to_uint8(want).numpy())


def test_page_stream_server_chunked_matches_direct(pipe, rng):
    """chunk=2 through serve(): per-batch results, in order, with a tail
    short of a chunk."""
    batches = u8_batches(rng, 5)
    got = list(PageStreamServer(pipe, depth=1, chunk=2).serve(iter(batches)))
    assert len(got) == 5
    for pages, (clean_u8, mask_u8) in zip(batches, got):
        want_clean, want_mask = direct(pipe, pages)
        np.testing.assert_array_equal(clean_u8, want_clean)
        np.testing.assert_array_equal(mask_u8, want_mask)


def test_served_pages_match_jax_run():
    """The server on JAX's small_pipe weights against ``jax.jit(pipe.run)``
    on the same uint8 pages / 255, at f32."""
    jax_pipe = jpipe.TextRemovalPipeline(
        seg=JaxTextSegmenter(width_mult=0.35, dtype=jnp.float32),
        unet=JaxInpaintUNet(depth=3, dtype=jnp.float32),
        compute_dtype=jnp.float32, dilate_radius=1,
    )
    seg_vars, unet_vars = jax_pipe.init_variables(jax.random.key(0), page_hw=(SIZE, SIZE))
    port = TextRemovalPipeline(port_segmenter(seg_vars, width_mult=0.35),
                               port_unet(unet_vars, depth=3), compute_dtype=torch.float32,
                               dilate_radius=1).eval()
    batches = u8_batches(np.random.default_rng(1), 3)
    got = list(PageStreamServer(port, depth=2).serve(iter(batches)))
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
        gap = np.abs(clean_u8.astype(int) - want_u8.astype(int))[keep]
        assert gap.max() <= 1, gap.max()
        text += int(mask_u8.sum())
    assert text > 0


# -- the threshold ---------------------------------------------------------------

class _LogitsAreChannel0(nn.Module):
    """A segmenter whose logits are the page's first channel."""

    def forward(self, x):
        return x[..., :1]


class _JaxLogitsAreChannel0:
    def apply(self, variables, x):
        return x[..., :1]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_threshold_masks_equal_jax(dtype, threshold):
    """Logits on and next to logit(t) rounded to the compute dtype, and
    random ones: the masks (raw and dilated) equal JAX's bit for bit.
    logit(0.3) is not a bf16 value, so this pins the rounding."""
    tdt = getattr(torch, dtype)
    thr = torch.full((), float(np.log(threshold / (1 - threshold))), dtype=tdt)
    ulp = torch.finfo(tdt).eps * max(1.0, abs(float(thr)))
    near = torch.stack([thr + k * ulp for k in (-2, -1, 0, 1, 2)]).to(tdt)
    assert (near[2] == thr) and len(set(near.tolist())) == 5
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32)).to(tdt)
    logits.view(-1)[:40] = near.repeat(8)
    pages = torch.zeros((2, 8, 16, 3), dtype=tdt)
    pages[..., 0] = logits
    port = TextRemovalPipeline(_LogitsAreChannel0(), InpaintUNet(depth=3), threshold=threshold,
                               dilate_radius=1, compute_dtype=tdt)
    jax_pipe = jpipe.TextRemovalPipeline(
        threshold=threshold, dilate_radius=1, seg=_JaxLogitsAreChannel0(),
        unet=JaxInpaintUNet(depth=3), compute_dtype=getattr(jnp, dtype))
    x = jnp.asarray(pages.float().numpy(), getattr(jnp, dtype))
    for dilate in (False, True):
        got = port.segment(pages, dilate=dilate).float().numpy()
        want = np.asarray(jax_pipe.segment(None, x, dilate=dilate)).astype(np.float32)
        np.testing.assert_array_equal(got, want)
    raw = port.segment(pages, dilate=False)[..., 0]
    assert torch.equal(raw > 0, logits > thr)
    assert 0 < int(raw.sum()) < raw.numel()


# -- the prefetcher ----------------------------------------------------------------

def test_prefetcher_yields_tensors_in_order():
    batches = [{"image": np.full((2, 4, 4, 3), i, np.uint8), "meta": (np.arange(3) + i,)}
               for i in range(3)]
    pf = DevicePrefetcher(iter(batches), device="cpu")
    got = list(pf)
    assert len(got) == 3
    for i, b in enumerate(got):
        assert isinstance(b["image"], torch.Tensor) and b["image"].dtype == torch.uint8
        assert int(b["image"][0, 0, 0, 0]) == i and b["meta"][0].tolist() == [i, i + 1, i + 2]
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_raises_a_worker_exception_once():
    def bad_iter():
        yield {"x": np.zeros((2, 4, 4, 3), np.float32)}
        raise ValueError("corrupt image")

    pf = DevicePrefetcher(bad_iter(), device="cpu")
    next(pf)
    with pytest.raises(ValueError, match="corrupt image"):
        next(pf)
    with pytest.raises(StopIteration):  # after the exception the iterator stops
        next(pf)
    pf.close()


def test_prefetcher_close_unblocks_a_full_queue():
    """An endless producer blocked on a full queue stops on close()."""
    produced = threading.Event()

    def endless():
        while True:
            produced.set()
            yield {"x": np.zeros((2, 2), np.float32)}

    pf = DevicePrefetcher(endless(), device="cpu", depth=1)
    assert produced.wait(timeout=10)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()


# -- serving pages -------------------------------------------------------------------

def test_page_stream_u8_equals_jax(jax_native_engines):
    a = make_page_stream_u8(batch_size=2, size=(64, 48), seed=3)
    b = jax_page_stream_u8(batch_size=2, size=(64, 48), seed=3)
    for _ in range(2):
        got, want = next(a)["image"], next(b)["image"]
        assert got.dtype == np.uint8 and got.shape == (2, 64, 48, 3)
        np.testing.assert_array_equal(got, want)


def test_glyph_atlas_file_is_the_pil_rendering():
    with np.load(native_pages.ATLAS_PATH) as f:
        stored = (f["bits"], f["meta"], f["sizes"])
    for got, want in zip(stored, native_pages.render_atlas()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_page_stream_u8_needs_no_pil():
    """The GPU host has no PIL: the serving pages are drawn without it."""
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "from text_segmentation_image_inpainting_tpu_torch.data.pipeline import "
        "make_page_stream_u8\n"
        "print(int(next(make_page_stream_u8(2, (64, 48), 3))['image'].astype('int64').sum()))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = next(make_page_stream_u8(2, (64, 48), 3))["image"].astype(np.int64).sum()
    assert int(proc.stdout) == int(want)
