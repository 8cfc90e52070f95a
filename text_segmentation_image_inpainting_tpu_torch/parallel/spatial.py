"""Spatial (H-axis) sharding with conv halo exchange.

Counterpart of the explicit-halo part of
``text_segmentation_image_inpainting_tpu/parallel/spatial.py``. A page
batch (N, H, W, C) is cut into one band of H / n rows per mesh entry, and
each band runs in a host thread of its own, on its entry's device and
CUDA stream (the recipe of ``torch.nn.parallel.parallel_apply``). Before
each conv a band takes k//2 rows from each neighbour: each band publishes
its rows with an event recorded on its stream, and once all have, each
makes its own stream wait on its neighbours' events before it copies their
rows, so the host never waits for the device. Past the page's ends a band
takes zero rows (the global zero padding of a conv or the max-pool) or,
for the bilinear resize, none, so the sharded result equals the unsharded
one (``ShardRing.exchange_rows``).

The bands' threads take turns: one runs at a time, from one exchange to
the next, then hands the turn on; after the last band has published, the
first goes on. The device still runs the bands' streams at once. Threads
that ran at once would contend for the GIL at every torch call, and that
costs more than the work (``tools/parallel_times.py`` on an H100: a
2048^2 page in 4 bands took 156 ms all at once, 69 ms in turns). The
threads are kept across calls (``parallel.mesh.host_pool``): torch keeps
cuDNN's execution plans per thread.

:func:`spatial_inpaint_unet` runs the *unmodified* ``InpaintUNet.forward``
once per band under ``ops.bands.spatial_axis``: every partial conv (the
stride-2 encoder too) takes its halo and convolves with H padding 0. On
the card the stride-1 layers then run K1 and K2 with padding (0, 1).
:func:`spatial_pipeline_run` runs the whole pipeline so: the segmenter's
convs, its bilinear resizes and the dilation take their rows the same way
(``ops/bands.py``).

Grad mode is per thread: the bands run under ``no_grad``, with the
modules in eval mode (BatchNorm on its running statistics, which needs no
statistic across bands). A band that raises breaks the ring, so the
others raise too instead of waiting; the first error is re-raised.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import torch

from text_segmentation_image_inpainting_tpu_torch.ops.bands import spatial_axis
from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d_local
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import partial_conv2d
from text_segmentation_image_inpainting_tpu_torch.pipeline.end_to_end import pad_to_multiple
from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    distinct_devices,
    entry_streams,
    host_pool,
    on_stream,
    replicate,
)

# Seconds a band waits for its turn before it gives up: far above any
# layer's time, so it only ends a band whose peer is lost.
TURN_TIMEOUT_S = 300.0


class _Ring:
    """What the bands of one sharded call share: the turn (which band's
    thread runs) and two generations of slots (edge rows and event),
    alternating by exchange. Band i reads its neighbours' rows of exchange
    e in its first turn after it, before it publishes e + 1; a neighbour
    writes e + 2, the same generation, only a whole round of turns later."""

    def __init__(self, n: int, timeout: float):
        self.n = n
        self.timeout = timeout
        self.slots = ([None] * n, [None] * n)
        self._cond = threading.Condition()
        self._turn = 0
        self._broken = False

    def wait_turn(self, i: int) -> None:
        with self._cond:
            if not self._cond.wait_for(lambda: self._turn == i or self._broken, self.timeout):
                self._broken = True
                self._cond.notify_all()
            if self._broken:
                raise threading.BrokenBarrierError(f"band {i}: another band failed or is lost")

    def pass_turn(self, i: int) -> None:
        with self._cond:
            self._turn = (i + 1) % self.n
            self._cond.notify_all()

    def abort(self) -> None:
        with self._cond:
            self._broken = True
            self._cond.notify_all()


class ShardRing:
    """One band's view of its ring: ``exchange_rows``, the counterpart of
    JAX's ``ops/partial_conv.py::_halo_exchange_rows``, and ``band_sum``,
    which the ops under ``ops.bands.spatial_axis`` call."""

    def __init__(self, ring: _Ring, rank: int, device: torch.device,
                 stream: torch.cuda.Stream | None):
        self._ring = ring
        self.rank = rank
        self.device = device
        self.stream = stream
        self._calls = 0

    @property
    def bands(self) -> int:
        return self._ring.n

    def _publish(self, tensors) -> list:
        """Publish this band's tensors with an event on its stream, then wait
        until every band has published: one round of turns. Returns the
        slots of this exchange."""
        ring, i = self._ring, self.rank
        slots = ring.slots[self._calls % 2]
        self._calls += 1
        done = None
        if self.stream is not None:
            done = torch.cuda.Event()
            done.record(self.stream)
        slots[i] = (tensors, done)
        ring.pass_turn(i)
        ring.wait_turn(i)  # every band has published
        return slots

    def exchange_rows(self, tensors, above: int, below: int, *, ends: str = "zeros"):
        """Each (N, Hl, ...) tensor with ``above`` rows of the bands above
        and ``below`` rows of the bands below concatenated along H. A halo
        longer than a band reaches the bands beyond. Past the page's ends,
        ``ends`` says what a band takes: ``"zeros"``, rows of zeros (the
        global zero padding of a conv or the max-pool), or ``"none"``,
        nothing (the bilinear resize, which clamps at the page's edge).
        Every band calls every exchange, the end bands too: one round of
        turns per call, for all the tensors."""
        if ends not in ("zeros", "none"):
            raise ValueError(f"ends must be 'zeros' or 'none', got {ends!r}")
        single = isinstance(tensors, torch.Tensor)
        ts = (tensors,) if single else tuple(tensors)
        slots = self._publish(ts)
        out = []
        for j, t in enumerate(ts):
            parts = self._gather(slots, j, t, above, -1, ends)[::-1] + [t]
            parts += self._gather(slots, j, t, below, 1, ends)
            out.append(torch.cat(parts, dim=1) if len(parts) > 1 else t)
        return out[0] if single else out

    def _gather(self, slots, j: int, like: torch.Tensor, rows: int, step: int, ends: str) -> list:
        """``rows`` rows of tensor j from the bands in direction ``step``
        (-1 up, +1 down), nearest first."""
        parts, band = [], self.rank + step
        while rows > 0:
            if not 0 <= band < self._ring.n:  # past the page's end
                if ends == "zeros":
                    parts.append(like.new_zeros((like.shape[0], rows, *like.shape[2:])))
                break
            (slabs, done) = slots[band]
            slab = slabs[j]
            take = min(rows, slab.shape[1])
            slab = slab[:, slab.shape[1] - take:] if step < 0 else slab[:, :take]
            if done is not None:
                self.stream.wait_event(done)
            parts.append(_to(slab, self.device))
            rows -= take
            band += step
        return parts

    def band_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every band's ``t`` (each band's own, of one shape),
        added in band order, so that every band gets the same bits."""
        slots = self._publish((t,))
        total = None
        for (slabs, done) in slots:
            if done is not None:
                self.stream.wait_event(done)
            v = _to(slabs[0], self.device)
            total = v if total is None else total + v
        return total


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``, read on this thread's current stream: the
    allocator is told, so ``t``'s memory outlives the read."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t.to(device, non_blocking=True)


def run_bands(mesh: Mesh, fn: Callable, inputs: Sequence[torch.Tensor]):
    """``fn(ring, *bands)`` for each mesh entry, in a host thread of its
    own (``host_pool``; the threads taking turns), on the entry's device
    and a stream of its own, under ``no_grad``;
    ``bands`` are the entry's H bands of ``inputs`` (N, H, W, C). Returns
    ``fn``'s output (a tensor or a tuple of them) with the bands
    concatenated along H on the first input's device, ordered after every
    band's work on the caller's current stream."""
    devs = mesh.device_list
    n = len(devs)
    h = inputs[0].shape[1]
    if h % n:
        raise ValueError(f"H {h} does not split over {n} mesh entries")
    hl = h // n
    out_device = inputs[0].device
    streams = entry_streams(devs)
    ready = None
    if inputs[0].is_cuda:  # the bands start after the caller's work on the inputs
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(inputs[0].device))
    ring = _Ring(n, TURN_TIMEOUT_S)
    results: list = [None] * n
    errors: list = [None] * n

    def work(i: int) -> None:
        try:
            ring.wait_turn(i)
            with torch.no_grad(), on_stream(devs[i], streams[i]):
                if ready is not None:
                    streams[i].wait_event(ready)
                bands = [_to(t[:, i * hl:(i + 1) * hl], devs[i]).contiguous() for t in inputs]
                out = fn(ShardRing(ring, i, devs[i], streams[i]), *bands)
                done = None
                if streams[i] is not None:
                    done = torch.cuda.Event()
                    done.record(streams[i])
                results[i] = (out, done)
            ring.pass_turn(i)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors[i] = e
            ring.abort()

    for f in [host_pool().submit(work, i) for i in range(n)]:
        f.result()
    failed = [e for e in errors if e is not None]
    if failed:
        # the band that failed first, not the peers its abort woke
        raise next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)),
                   failed[0])
    if out_device.type == "cuda":
        caller = torch.cuda.current_stream(out_device)
        for _, done in results:
            if done is not None:
                caller.wait_event(done)
    single = isinstance(results[0][0], torch.Tensor)
    outs = [(o,) if single else tuple(o) for o, _ in results]
    cat = tuple(torch.cat([_to(o[j], out_device) for o in outs], dim=1)
                for j in range(len(outs[0])))
    return cat[0] if single else cat


def halo_exchange_rows(x: torch.Tensor, halo: int, ring: ShardRing) -> torch.Tensor:
    """Concatenate ``halo`` rows from each H neighbour: (N, Hl, W, C) ->
    (N, Hl + 2 halo, W, C), zeros at the ring's ends. The symmetric form
    of ``ShardRing.exchange_rows``, which also serves the stride-2 halos."""
    if halo <= 0:
        return x
    return ring.exchange_rows(x, halo, halo)


def spatial_partial_conv2d(mesh: Mesh, x: torch.Tensor, mask: torch.Tensor,
                           weight: torch.Tensor, bias: torch.Tensor | None = None, *,
                           group_sizes: Sequence[int] | None = None):
    """Stride-1, torch-'same' partial conv over H bands: x (N, H, W, Cin)
    with H divisible by the mesh's size, weight (Cout, Cin, k, k).
    Returns (y, new_mask), gathered."""
    k = weight.shape[2]
    halo = (k - 1) // 2
    weights = {d: (weight.to(d), None if bias is None else bias.to(d))
               for d in distinct_devices(mesh)}

    def local(ring, xb, mb):
        xb, mb = ring.exchange_rows((xb, mb.to(xb.dtype)), halo, halo)
        w, b = weights[ring.device]
        return partial_conv2d(xb, mb, w, b, group_sizes=group_sizes, padding=(0, halo))

    return run_bands(mesh, local, (x, mask))


def spatial_conv2d(mesh: Mesh, x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain stride-1 'same' conv over H bands."""
    k = weight.shape[2]
    halo = k // 2
    weights = {d: (weight.to(d), None if bias is None else bias.to(d))
               for d in distinct_devices(mesh)}

    def local(ring, xb):
        w, b = weights[ring.device]
        return conv2d_local(halo_exchange_rows(xb, halo, ring), w, b, stride=1,
                            padding=(0, halo))

    return run_bands(mesh, local, (x,))


def spatial_inpaint_unet(mesh: Mesh, unet, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The whole ``InpaintUNet`` forward with H over the mesh's entries.

    The unmodified ``unet.forward`` runs once per band (a replica per
    distinct device) under ``spatial_axis``: every partial conv takes its
    halo rows from the neighbouring bands; nearest upsampling and
    BatchNorm (eval mode, running statistics) are band-local. Needs the
    local H divisible by ``2**unet.depth`` and no self-attention block
    (attention mixes all rows). x (N, H, W, 3) with the holes zeroed, mask
    (N, H, W, 1); returns (N, H, W, 3) on x's device.
    """
    if unet.attn is not None:
        raise ValueError("spatial_inpaint_unet takes no self-attention block: it is not band-local")
    n = mesh.shape[DATA_AXIS]
    if x.shape[1] % n or (x.shape[1] // n) % (1 << unet.depth):
        raise ValueError(
            f"local H {x.shape[1]}/{n} must be divisible by 2**depth={1 << unet.depth}")
    replicas = {d: replicate(unet, d) for d in distinct_devices(mesh)}
    modes = [(r, r.training) for r in replicas.values()]
    for r, _ in modes:
        r.eval()

    def local(ring, xb, mb):
        with spatial_axis(ring):
            return replicas[ring.device](xb, mb)

    try:
        return run_bands(mesh, local, (x, mask))
    finally:
        for r, training in modes:
            r.train(training)


def spatial_pipeline_run(mesh: Mesh, pipe, pages: torch.Tensor):
    """The whole page pipeline (segment -> threshold -> dilate -> inpaint
    -> composite) with the pages' H cut into one band per mesh entry:
    counterpart of JAX's ``spatial_pipeline_run``.

    The unmodified ``pipe._segment2d`` and ``pipe._inpaint2d`` run once per
    band (a replica of ``pipe`` per distinct device, in eval mode) under
    ``spatial_axis``: the segmenter's convs, its bilinear resizes and the
    dilation take their halo rows from the other bands (``ops/bands.py``),
    the U-Net's partial convs theirs, as in :func:`spatial_inpaint_unet`.
    With the MobileNetV2 segmenter the result equals ``pipe.run``'s (on the
    CPU bit for bit); DeepLab's image pooling sums across the bands in
    another order than the unbanded mean, so it agrees to rounding.

    pages (N, H, W, 3) in [0, 1], edge-padded first as ``run`` pads them;
    the padded H must be divisible by ``n * 2**pipe.unet.depth`` and the
    U-Net may have no self-attention block. Returns ``run``'s (clean,
    text_mask), gathered on the pages' device. Where JAX takes variables
    and returns H-sharded arrays, this takes the module and returns
    gathered tensors.
    """
    unet = pipe.unet
    if unet.attn is not None:
        raise ValueError("spatial_pipeline_run takes no self-attention block: it is not band-local")
    padded, (h, w) = pad_to_multiple(pages, 1 << unet.depth)
    n = mesh.shape[DATA_AXIS]
    if padded.shape[1] % (n << unet.depth):
        raise ValueError(f"padded H {padded.shape[1]} must be divisible by {n} bands x "
                         f"2**depth={1 << unet.depth}")
    replicas = {d: replicate(pipe, d) for d in distinct_devices(mesh)}
    modes = [(m, m.training) for r in replicas.values() for m in r.modules()]
    for r in replicas.values():
        r.eval()

    def local(ring, pb):
        r = replicas[ring.device]
        with spatial_axis(ring):
            valid2d = r._segment2d(pb)
            clean = r._inpaint2d(pb, valid2d)
        return clean, (1.0 - valid2d)[..., None]

    try:
        clean, text = run_bands(mesh, local, (padded,))
    finally:
        for m, training in modes:
            m.training = training
    return clean[:, :h, :w], text[:, :h, :w]
