"""Changed-tile result wire for serving: ship only the tiles text touched.

Counterpart of ``text_segmentation_image_inpainting_tpu/pipeline/sparse.py``.
The pipeline's composite is ``valid*page + text*inpaint``, so every pixel
outside the dilated text mask is the input byte: the device needs to
return only the ``TS x TS`` tiles the mask touches.

Device side (:func:`sparse_pack`, :func:`sparse_flatten`, torch ops on
the pages' device): cut the clean page (as uint8) and the mask into
tiles; a tile is *changed* iff its mask max is above 0; sort the unique
key ``where(changed, 0, T) + tile_index`` so the changed tiles come
first in row-major order, gather the first ``K`` slots with their
indices and the true changed count, and pack all four into one flat
uint8 buffer per page, byte for byte the JAX package's layout. Host side
(:func:`sparse_unflatten`, :func:`sparse_recompose`, numpy): unpack and
paste the tiles over the caller's original page. Pages with more than
``K`` changed tiles are flagged so the caller can redo them densely.

The text region comes back bit-exact (the bytes the dense path would
ship); outside it the caller keeps its own bytes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class SparsePages(NamedTuple):
    """A packed batch (all shapes fixed by N, K and TS).

    tiles: (N, K, TS, TS, 3) uint8, changed clean-page tiles, the first
      ``count`` valid, the rest unchanged tiles.
    mask_tiles: (N, K, TS, TS) uint8, the text mask of the same tiles.
    index: (N, K) int32, row-major tile index of each slot.
    count: (N,) int32, the TRUE number of changed tiles (above K: the page
      overflowed and must be redone densely).
    """

    tiles: torch.Tensor | np.ndarray
    mask_tiles: torch.Tensor | np.ndarray
    index: torch.Tensor | np.ndarray
    count: torch.Tensor | np.ndarray


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] pages -> uint8: round(clip(f32(x), 0, 1) * 255), half to even."""
    return torch.round(x.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def sparse_pack(clean: torch.Tensor, text_mask2d: torch.Tensor, *, max_tiles: int = 64,
                tile: int = 32) -> SparsePages:
    """(clean (N,H,W,3) in [0,1], text_mask2d (N,H,W)) -> changed-tile form,
    on their device. ``K = min(max_tiles, tiles per page)``."""
    n, h, w, _ = clean.shape
    if h % tile or w % tile:
        raise ValueError(f"page {h}x{w} is not a multiple of tile {tile}")
    th, tw = h // tile, w // tile
    t = th * tw
    k = min(max_tiles, t)
    tiles = (to_uint8(clean).reshape(n, th, tile, tw, tile, 3)
             .permute(0, 1, 3, 2, 4, 5).reshape(n, t, tile, tile, 3))
    mtiles = (text_mask2d.reshape(n, th, tile, tw, tile)
              .permute(0, 1, 3, 2, 4).reshape(n, t, tile, tile))
    changed = mtiles.amax(dim=(2, 3)) > 0  # (N, T)
    # unique keys: changed tiles first, each group in row-major order
    key = torch.where(changed, 0, t) + torch.arange(t, dtype=torch.int32, device=clean.device)
    order = torch.argsort(key, dim=1)[:, :k]  # (N, K) int64
    rows = torch.arange(n, device=clean.device)[:, None]
    return SparsePages(
        tiles[rows, order],
        mtiles[rows, order].to(torch.uint8),
        order.to(torch.int32),
        changed.sum(dim=1, dtype=torch.int32),
    )


def sparse_flatten(packed: SparsePages) -> torch.Tensor:
    """One (N, B) uint8 buffer per batch, so the host reads it in a single
    copy: tiles | mask bits (8 pixels a byte, least significant first) |
    index | count (int32, little-endian bytes)."""
    n, k, ts = packed.mask_tiles.shape[:3]
    shifts = torch.arange(8, dtype=torch.int32, device=packed.mask_tiles.device)
    mbits = (packed.mask_tiles.reshape(n, k, ts, ts // 8, 8).to(torch.int32) << shifts).sum(
        dim=-1).to(torch.uint8)
    return torch.cat([
        packed.tiles.reshape(n, -1),
        mbits.reshape(n, -1),
        packed.index.contiguous().view(torch.uint8).reshape(n, -1),
        packed.count.contiguous().view(torch.uint8).reshape(n, -1),
    ], dim=1)


def sparse_unflatten(buf: np.ndarray, *, max_tiles: int, tile: int) -> SparsePages:
    """Host-side inverse of :func:`sparse_flatten` (numpy views; the mask
    bits re-expanded to uint8 pixels)."""
    buf = np.ascontiguousarray(buf)
    n = buf.shape[0]
    k, ts = max_tiles, tile
    o0 = k * ts * ts * 3
    o1 = o0 + k * ts * (ts // 8)
    o2 = o1 + 4 * k
    o3 = o2 + 4
    if buf.shape[1] != o3:
        raise ValueError(f"buffer of {buf.shape[1]} bytes a page; K {k}, tile {ts} make {o3}")
    mask_tiles = np.unpackbits(buf[:, o0:o1].reshape(n, k, ts, ts // 8), axis=-1,
                               bitorder="little")
    return SparsePages(
        buf[:, :o0].reshape(n, k, ts, ts, 3),
        mask_tiles,
        np.ascontiguousarray(buf[:, o1:o2]).view("<i4").reshape(n, k),
        np.ascontiguousarray(buf[:, o2:o3]).view("<i4").reshape(n),
    )


def sparse_recompose(pages_uint8: np.ndarray, packed: SparsePages, *,
                     tile: int = 32) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paste the packed tiles over the caller's uint8 pages on the host:
    -> (clean (N,H,W,3) uint8, text_mask (N,H,W,1) uint8, overflow (N,) bool).

    ``packed`` holds numpy arrays or CPU tensors. Overflowed pages
    (count > K) come back as the unmodified input: callers redo them
    densely.
    """
    tiles, mtiles, index, count = (np.asarray(a) for a in packed)
    n, h, w, _ = pages_uint8.shape
    tw = w // tile
    k = tiles.shape[1]
    clean = np.array(pages_uint8, copy=True)
    mask = np.zeros((n, h, w, 1), np.uint8)
    overflow = count > k
    for i in range(n):
        if overflow[i]:
            continue
        for j in range(int(count[i])):
            r, c = divmod(int(index[i, j]), tw)
            ys, xs = r * tile, c * tile
            clean[i, ys: ys + tile, xs: xs + tile] = tiles[i, j]
            mask[i, ys: ys + tile, xs: xs + tile, 0] = mtiles[i, j]
    return clean, mask, overflow


def sparse_bytes(packed: SparsePages) -> int:
    """Wire bytes of one packed batch."""
    return sum(a.nbytes for a in packed)
