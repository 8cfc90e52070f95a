"""The H-band context: one thread's ops run on one H band of its pages.

``spatial_axis(ring)`` is a per-thread switch, as JAX's ``threading.local()``
context holds its axis name (``ops/partial_conv.py``): while it is active,
the ops of this thread that mix rows (``conv2d``, ``partial_conv2d``,
``resize_bilinear``, ``dilate_mask`` and ``mean_hw``) see one H band of
every page and take what they need from the other bands through ``ring``
(``parallel.spatial.ShardRing``), so that the banded result equals the
unbanded op's. The unmodified models then run banded, one host thread per
band (``parallel/spatial.py``). Row-local ops (BatchNorm in eval mode,
activations, nearest upsampling, channel concatenation) need nothing.

Every band of a ring calls the same exchanges in the same order (the
decisions below depend only on static shapes), so the turn order holds.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_ctx = threading.local()


@contextlib.contextmanager
def spatial_axis(ring):
    """Run this thread's row-mixing ops on an H band: ``ring`` is the
    band's view of its ring of bands, with ``exchange_rows(tensors, above,
    below, ends=...)`` and ``band_sum(t)`` (``parallel.spatial.ShardRing``)."""
    prev = getattr(_ctx, "axis", None)
    _ctx.axis = ring
    try:
        yield
    finally:
        _ctx.axis = prev


def active_spatial_axis():
    """This thread's ring, or None outside ``spatial_axis``."""
    return getattr(_ctx, "axis", None)


def conv_halo(ring, tensors, kernel: int, stride: int, padding: int, dilation: int):
    """A conv's H halo for a band: ``tensors`` (a tuple, each (N, Hl, ...))
    with ``padding`` rows of the bands above and ``padding - (stride - 1)``
    (at least 0) of the bands below, zeros past the page (the conv's zero
    padding), to be convolved with H padding 0.

    The band's first output row y0 = Hl * i / s reads from s * y0 - p, so
    the top takes p rows; its last, y0 + Hl / s - 1, reads up to
    Hl * (i + 1) - 1 + p - (s - 1), so the bottom takes p - (s - 1). Where
    that is negative (a 1x1 stride-2 conv: p = 0) the band's last rows are
    not read at all and the band takes nothing: the output still has
    Hl / s rows, since a band starts on a multiple of the stride."""
    if padding != dilation * (kernel - 1) // 2:
        raise ValueError(f"spatial mode requires torch-same H padding, got p={padding} for "
                         f"k={kernel}, dilation={dilation}")
    if tensors[0].shape[1] % stride:
        raise ValueError(f"spatial mode needs the local H {tensors[0].shape[1]} divisible by the "
                         f"stride {stride}")
    above, below = padding, max(padding - (stride - 1), 0)
    if above == below == 0:
        return tuple(tensors)
    return tuple(ring.exchange_rows(tuple(tensors), above, below))


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(dim=(1, 2), keepdim=True)`` of (N, H, W, C), over the whole
    page under ``spatial_axis``: each band's sum over its rows in f32, the
    bands' sums added in band order (so every band gets the same bits),
    divided by the page's H * W, cast to x.dtype. The order of the sums
    differs from the unbanded mean's, so the two agree to rounding only."""
    ring = active_spatial_axis()
    if ring is None:
        return x.mean(dim=(1, 2), keepdim=True)
    local = x.sum(dim=(1, 2), keepdim=True, dtype=torch.float32)
    total = ring.band_sum(local)
    return (total / float(x.shape[1] * ring.bands * x.shape[2])).to(x.dtype)
