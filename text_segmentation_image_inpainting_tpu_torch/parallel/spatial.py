"""Spatial (H-axis) sharding with conv halo exchange.

Counterpart of the explicit-halo part of
``text_segmentation_image_inpainting_tpu/parallel/spatial.py``. A page
batch (N, H, W, C) is cut into one band of H / n rows per mesh entry, and
each band runs in a host thread of its own, on its entry's device and
CUDA stream (the recipe of ``torch.nn.parallel.parallel_apply``). Before
each conv a band takes k//2 rows from each neighbour: each band publishes
its edge rows with an event recorded on its stream, and once all have,
each makes its own stream wait on its neighbours' events before it copies
their rows, so the host never waits for the device. The first and last
bands get zero rows there, which is the global zero padding, so the
sharded result equals the unsharded one.

The bands' threads take turns: one runs at a time, from one exchange to
the next, then hands the turn on; after the last band has published, the
first goes on. The device still runs the bands' streams at once. Threads
that ran at once would contend for the GIL at every torch call, and that
costs more than the work (``tools/parallel_times.py`` on an H100: a
2048^2 page in 4 bands took 156 ms all at once, 69 ms in turns). The
threads are kept across calls (``parallel.mesh.host_pool``): torch keeps
cuDNN's execution plans per thread.

:func:`spatial_inpaint_unet` runs the *unmodified* ``InpaintUNet.forward``
once per band under ``ops.partial_conv.spatial_axis``: every partial conv
(the stride-2 encoder too) takes its halo and convolves with H padding 0.
On the card the stride-1 layers then run K1 and K2 with padding (0, 1).

Grad mode is per thread: the bands run under ``no_grad``, with the
modules in eval mode (BatchNorm on its running statistics, which needs no
statistic across bands). A band that raises breaks the ring, so the
others raise too instead of waiting; the first error is re-raised.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import torch

from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import partial_conv2d, spatial_axis
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
    JAX's ``ops/partial_conv.py::_halo_exchange_rows``, is what
    ``ops.partial_conv.spatial_axis`` calls."""

    def __init__(self, ring: _Ring, rank: int, device: torch.device,
                 stream: torch.cuda.Stream | None):
        self._ring = ring
        self.rank = rank
        self.device = device
        self.stream = stream
        self._calls = 0

    def exchange_rows(self, tensors, above: int, below: int):
        """Each (N, Hl, W, C) tensor with ``above`` rows of the band above
        and ``below`` rows of the band below concatenated along H (zeros
        at the ring's ends). One round of turns per call, for all the
        tensors."""
        single = isinstance(tensors, torch.Tensor)
        ts = (tensors,) if single else tuple(tensors)
        ring, i = self._ring, self.rank
        slots = ring.slots[self._calls % 2]
        self._calls += 1
        done = None
        if self.stream is not None:
            done = torch.cuda.Event()
            done.record(self.stream)
        slots[i] = ([t[:, :below] for t in ts] if below > 0 else None,
                    [t[:, t.shape[1] - above:] for t in ts] if above > 0 else None, done)
        ring.pass_turn(i)
        ring.wait_turn(i)  # every band has published
        up = slots[i - 1] if i > 0 else None
        down = slots[i + 1] if i + 1 < ring.n else None
        out = []
        for j, t in enumerate(ts):
            parts = []
            if above > 0:
                parts.append(self._take(up, 1, j, t, above))
            parts.append(t)
            if below > 0:
                parts.append(self._take(down, 0, j, t, below))
            out.append(torch.cat(parts, dim=1) if len(parts) > 1 else t)
        return out[0] if single else out

    def _take(self, slot, which: int, j: int, like: torch.Tensor, rows: int) -> torch.Tensor:
        if slot is None:  # a ring end: the global zero padding
            return like.new_zeros((like.shape[0], rows, *like.shape[2:]))
        slab, done = slot[which][j], slot[2]
        if slab.shape[1] != rows:
            raise ValueError(f"a band of {slab.shape[1]} rows cannot give a halo of {rows}")
        if done is not None:
            self.stream.wait_event(done)
        return _to(slab, self.device)


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
        return conv2d(halo_exchange_rows(xb, halo, ring), w, b, stride=1, padding=(0, halo))

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
