"""The port's changed-tile wire (``pipeline/sparse.py``) against the JAX
package's, on the CPU: the flat buffer ``sparse_flatten(sparse_pack(...))``
must be byte for byte JAX's for the same pages and masks, and the host
half must paste it back as JAX's does.

Pages are 32x32 with 16x16 tiles (4 tiles a page), as in
tests/test_sparse_serve.py: a page with one changed tile, one with none,
one with all four; a budget below the changed count (overflow) and one
above the page's tile count (the slot count is clamped to it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import one_torch_thread
from text_segmentation_image_inpainting_tpu.pipeline import sparse as jsparse
from text_segmentation_image_inpainting_tpu_torch.pipeline import sparse

SIZE = 32
TILE = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _pages(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n = 3
    # values beyond [0, 1] and exact half steps exercise the clip and the
    # round-half-to-even of the uint8 conversion
    clean = rng.uniform(-0.2, 1.2, (n, SIZE, SIZE, 3)).astype(dtype)
    clean[0, 0, :8, 0] = np.arange(8, dtype=dtype) * 0.5 / 255.0
    mask2d = np.zeros((n, SIZE, SIZE), dtype)
    mask2d[0, 3, TILE + 5] = 1.0  # page 0: one changed tile, by one pixel
    mask2d[2] = (rng.random((SIZE, SIZE)) < 0.5)  # page 2: all four
    mask2d[2, 0, 0] = mask2d[2, 0, TILE] = mask2d[2, TILE, 0] = mask2d[2, TILE, TILE] = 1.0
    inputs = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    return clean, mask2d, inputs


def _wire(clean, mask2d, max_tiles):
    want = np.asarray(jsparse.sparse_flatten(jsparse.sparse_pack(
        jnp.asarray(clean), jnp.asarray(mask2d), max_tiles=max_tiles, tile=TILE)))
    got = sparse.sparse_flatten(sparse.sparse_pack(
        torch.from_numpy(clean), torch.from_numpy(mask2d), max_tiles=max_tiles, tile=TILE))
    assert got.dtype == torch.uint8
    return got.numpy(), want


@pytest.mark.parametrize("max_tiles", [1, 2, 4, 9], ids=lambda k: f"K{k}")
def test_wire_bytes_equal_jax(max_tiles):
    clean, mask2d, _ = _pages()
    got, want = _wire(clean, mask2d, max_tiles)
    k = min(max_tiles, 4)
    assert got.shape == want.shape == (3, k * TILE * TILE * 3 + k * TILE * TILE // 8 + 4 * k + 4)
    np.testing.assert_array_equal(got, want)


def test_wire_bytes_equal_jax_bf16():
    """The pipeline's bf16 output: the f32 upcast before the rounding."""
    clean, mask2d, _ = _pages(seed=1)
    want = np.asarray(jsparse.sparse_flatten(jsparse.sparse_pack(
        jnp.asarray(clean, jnp.bfloat16), jnp.asarray(mask2d, jnp.bfloat16), max_tiles=4,
        tile=TILE)))
    got = sparse.sparse_flatten(sparse.sparse_pack(
        torch.from_numpy(clean).bfloat16(), torch.from_numpy(mask2d).bfloat16(), max_tiles=4,
        tile=TILE)).numpy()
    np.testing.assert_array_equal(got, want)


def test_unflatten_and_recompose_match_jax():
    """The host half on the same buffer: every field, the pasted pages,
    the masks and the overflow flags equal JAX's, at a budget with an
    overflowed page (K 2: page 2 has 4 changed tiles)."""
    clean, mask2d, inputs = _pages()
    for k in (2, 4):
        buf, _ = _wire(clean, mask2d, k)
        got = sparse.sparse_unflatten(buf, max_tiles=k, tile=TILE)
        want = jsparse.sparse_unflatten(buf, max_tiles=k, tile=TILE)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert list(got.count) == [1, 0, 4]
        for g, w in zip(sparse.sparse_recompose(inputs, got, tile=TILE),
                        jsparse.sparse_recompose(inputs, want, tile=TILE)):
            np.testing.assert_array_equal(g, w)
        assert sparse.sparse_bytes(got) == jsparse.sparse_bytes(want)


def test_pack_roundtrip():
    """flatten -> unflatten -> recompose puts back the changed tiles bit for
    bit and leaves the other tiles as the caller's bytes (JAX's
    test_sparse_pack_roundtrip, on the port alone)."""
    clean, mask2d, inputs = _pages()
    packed = sparse.sparse_pack(torch.from_numpy(clean), torch.from_numpy(mask2d), max_tiles=4,
                                tile=TILE)
    unpacked = sparse.sparse_unflatten(sparse.sparse_flatten(packed).numpy(), max_tiles=4,
                                       tile=TILE)
    np.testing.assert_array_equal(packed.count.numpy(), unpacked.count)
    got, gmask, overflow = sparse.sparse_recompose(inputs, unpacked, tile=TILE)
    assert not overflow.any()
    clean_u8 = np.round(np.clip(clean, 0, 1) * 255).astype(np.uint8)
    tflags = mask2d.reshape(3, 2, TILE, 2, TILE).max(axis=(2, 4))
    region = np.kron(tflags, np.ones((TILE, TILE))).astype(bool)
    np.testing.assert_array_equal(got[region], clean_u8[region])
    np.testing.assert_array_equal(got[~region], inputs[~region])
    np.testing.assert_array_equal(gmask[..., 0], mask2d.astype(np.uint8))
    assert list(unpacked.count) == [1, 0, 4]


def test_overflow_leaves_the_page_untouched():
    """count > K: the page is flagged and comes back as the input (JAX's
    test_sparse_pack_counts_overflow), with the tensors of sparse_pack."""
    rng = np.random.default_rng(2)
    clean = torch.from_numpy(rng.random((1, SIZE, SIZE, 3)).astype(np.float32))
    packed = sparse.sparse_pack(clean, torch.ones(1, SIZE, SIZE), max_tiles=2, tile=TILE)
    inputs = np.zeros((1, SIZE, SIZE, 3), np.uint8)
    got, _, overflow = sparse.sparse_recompose(inputs, packed, tile=TILE)
    assert overflow.all() and int(packed.count[0]) == 4
    np.testing.assert_array_equal(got, inputs)


def test_to_uint8_rounds_half_to_even_like_jax():
    x = np.array([0.5, 1.5, 2.5, 254.5, -3.0, 300.0], np.float32) / 255.0
    want = np.asarray(jnp.round(jnp.clip(jnp.asarray(x), 0.0, 1.0) * 255.0).astype(jnp.uint8))
    np.testing.assert_array_equal(sparse.to_uint8(torch.from_numpy(x)).numpy(), want)


def test_pack_refuses_pages_off_the_tile():
    with pytest.raises(ValueError, match="multiple of tile"):
        sparse.sparse_pack(torch.zeros(1, 24, 32, 3), torch.zeros(1, 24, 32), tile=TILE)
