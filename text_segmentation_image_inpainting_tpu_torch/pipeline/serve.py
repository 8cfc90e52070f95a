"""Streaming page server: keep ``depth`` batches in flight on the card.

Counterpart of ``text_segmentation_image_inpainting_tpu/pipeline/serve.py``.
A :class:`~..data.pipeline.DevicePrefetcher` thread overlaps host page
production and the host-to-device copy with compute; each dispatch runs
``TextRemovalPipeline.run`` on the current stream, copies its result
``non_blocking`` into pinned host memory and records an event; the host
waits on a batch's event only once ``depth`` newer batches are in flight,
so the device-to-host copy of batch *i* rides under the compute of
batches *i+1..i+depth*. Nothing on the dispatch path synchronizes.

    server = PageStreamServer(pipe)                  # pipe on the card, eval()
    for clean, mask in server.serve(host_batches):   # numpy in, numpy out
        ...

``submit``/``collect`` give the same pipelining to push-style callers,
with ``chunk=k``: k submits are stacked on the host, computed one logical
batch at a time (bit-identical to the per-batch path) and read back in
one copy; :meth:`flush` or :meth:`drain` push out a partial tail. Pages go
in and out as uint8 by default.

``sparse_tiles=K`` returns changed tiles only (:mod:`.sparse`): the device
ships the at most K mask-touched tiles of each page in one flat uint8
buffer and the host pastes them over the caller's page. The budget
adapts to the content (the smallest power-of-two level that covered the
last 8 batches with 25% headroom); a page that overflows it is redone
once on the sparse wire at K, then densely.

``mesh=`` (``parallel.make_mesh``) serves data-parallel, the counterpart
of JAX's ``sharding=``: each batch splits along its leading axis over the
mesh's entries, each entry runs ``run`` on its part on its own device and
stream (one replica of the pipeline per distinct device; entries that
repeat a device share it), and the parts' results land in one pinned
host buffer in page order, one event per entry.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from text_segmentation_image_inpainting_tpu_torch.data.pipeline import DevicePrefetcher, upload
from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import (
    distinct_devices,
    entry_streams,
    on_stream,
    replicate,
    shard_batch,
)
from text_segmentation_image_inpainting_tpu_torch.pipeline.sparse import (
    sparse_flatten,
    sparse_pack,
    sparse_recompose,
    sparse_unflatten,
    to_uint8,
)


def to_compute(pages: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Pages as the pipeline's input: uint8 in [0, 255] times 1/255, both
    in ``dtype`` (as JAX multiplies by a weakly typed 1/255), or a float
    page cast to ``dtype``. The constant is a fill on the device: no host
    copy."""
    if pages.dtype == torch.uint8:
        return pages.to(dtype) * torch.full((), 1.0 / 255.0, dtype=dtype, device=pages.device)
    return pages.to(dtype)


class _Inflight(NamedTuple):
    chunked: bool
    k_used: int  # 0: dense
    host: Tuple[torch.Tensor, ...]  # the result's host copies (pinned on CUDA)
    done: list | None  # events recorded after the copies, one per mesh entry (CUDA)
    pages_u8: np.ndarray | None  # the caller's pages, the sparse paste canvas


class PageStreamServer:
    """Pipelined streaming executor for :class:`TextRemovalPipeline`.

    pipe: the pipeline, an ``nn.Module`` in eval mode; the server runs on
      the device its parameters are on.
    depth: in-flight batches before the oldest result is read back.
    output_uint8: return uint8 pages and masks (else compute-dtype floats,
      bf16 widened to float32 on the device, since numpy has no bfloat16).
    chunk: stack k logical batches per dispatch and result read.
    sparse_tiles: > 0 returns changed tiles only (needs ``output_uint8``
      and ``tile % 8 == 0``).
    mesh: serve data-parallel over the mesh's entries (a batch, or with
      ``chunk`` a stack of batches, splits along its leading axis).
    """

    def __init__(self, pipe, *, depth: int = 2, output_uint8: bool = True, chunk: int = 1,
                 sparse_tiles: int = 0, tile: int = 32, mesh=None):
        self._pipe = pipe
        self._mesh = mesh
        if mesh is None:
            self._device = next(pipe.parameters()).device
            self._entries = [(pipe, None)]  # the caller's current stream
        else:
            replicas = {d: replicate(pipe, d) for d in distinct_devices(mesh)}
            self._entries = [(replicas[d], s) for d, s in
                             zip(mesh.device_list, entry_streams(mesh.device_list))]
            self._device = mesh.device_list[0]
        self._depth = max(1, depth)
        self._uint8 = output_uint8
        self._chunk = max(1, chunk)
        self._sparse = int(sparse_tiles)
        self._tile = tile
        if self._sparse and not output_uint8:
            raise ValueError("sparse_tiles requires output_uint8=True (uint8 wire format)")
        if self._sparse and tile % 8 != 0:
            # the wire packs mask pixels 8 to a byte along the tile row
            raise ValueError(f"sparse serving needs tile % 8 == 0, got tile={tile}")
        # the adaptive tile budget: ``sparse_tiles`` is the largest; each
        # dispatch ships the smallest power-of-two level (from 16) that
        # covered the recent changed-tile counts with 25% headroom. An
        # undershoot is safe: ``count`` shows the overflow, and
        # _materialize_sparse redoes the page at the largest budget
        self._k_levels = []
        if self._sparse:
            lv = 16
            while lv < self._sparse:
                self._k_levels.append(lv)
                lv *= 2
            self._k_levels.append(self._sparse)
        self._k_next = self._sparse  # start safe, shrink to the content
        self._recent_counts: collections.deque = collections.deque(maxlen=8)
        self._wire_bytes = 0
        self._inflight: collections.deque = collections.deque()
        self._done: collections.deque = collections.deque()
        self._pending: list = []  # chunked submits, on the host

    # -- device programs (each on one replica of the pipeline) ---------------
    def _run(self, pipe, pages: torch.Tensor):
        clean, mask = pipe.run(to_compute(pages, pipe.compute_dtype))
        if self._uint8:
            return to_uint8(clean), mask.to(torch.uint8)
        # numpy has no bfloat16; float32 holds it exactly
        return tuple(r.float() if r.dtype == torch.bfloat16 else r for r in (clean, mask))

    def _run_sparse(self, pipe, pages: torch.Tensor, k: int) -> torch.Tensor:
        clean, mask = pipe.run(to_compute(pages, pipe.compute_dtype))
        return sparse_flatten(sparse_pack(clean, mask[..., 0], max_tiles=k, tile=self._tile))

    def _run_chunk(self, pipe, stack: torch.Tensor):
        # one logical batch at a time, as lax.map does: the same shapes and
        # kernels as the per-batch path, so the same bits
        outs = [self._run(pipe, pages) for pages in stack]
        return torch.stack([c for c, _ in outs]), torch.stack([m for _, m in outs])

    def _run_sparse_chunk(self, pipe, stack: torch.Tensor, k: int) -> torch.Tensor:
        return torch.stack([self._run_sparse(pipe, pages, k) for pages in stack])

    # -- dispatch helpers ----------------------------------------------------
    def _upload(self, pages) -> list:
        """Host pages on the device: one part per mesh entry (without a
        mesh, the whole batch)."""
        if self._mesh is None:
            return [upload(pages, self._device)]
        return shard_batch(self._mesh, pages)

    def _each(self, fn, parts: list) -> list:
        """``fn(pipe, part)`` per entry, in page order, each on its entry's
        stream after the caller's work (the upload); the results as tuples.
        The entries are dispatched one after the other from this thread: a
        thread per entry contends for the GIL and is slower
        (``tools/parallel_times.py``)."""
        outs = []
        for (pipe, stream), part in zip(self._entries, parts):
            if stream is None:  # without a mesh, or a CPU entry: the caller's stream
                outs.append(fn(pipe, part))
                continue
            caller = torch.cuda.current_stream(stream.device)
            with on_stream(stream.device, stream):
                stream.wait_stream(caller)
                part.record_stream(stream)
                outs.append(fn(pipe, part))
        return [o if isinstance(o, tuple) else (o,) for o in outs]

    def _host_u8(self, pages) -> np.ndarray:
        """The caller's pages as the uint8 canvas the sparse paste uses."""
        pages = np.asarray(pages)
        if pages.dtype != np.uint8:
            pages = np.round(np.clip(pages, 0.0, 1.0) * 255.0).astype(np.uint8)
        return pages

    def _to_host(self, parts: list):
        """Start the copy of the entries' results (``_each``) to the host:
        (host tensors, events). On CUDA into one fresh pinned tensor per
        output, each entry's part ``non_blocking`` at its offset on its
        own stream, with an event recorded after; a block stays with its
        numpy views until the caller drops them, so none is reused unread."""
        if self._device.type != "cuda":
            if len(parts) == 1:
                return parts[0], None
            return tuple(torch.cat(rs) for rs in zip(*parts)), None
        host = tuple(torch.empty((sum(p[j].shape[0] for p in parts), *r.shape[1:]),
                                 dtype=r.dtype, pin_memory=True)
                     for j, r in enumerate(parts[0]))
        done, off = [], 0
        for (_, stream), part in zip(self._entries, parts):
            n = part[0].shape[0]
            with on_stream(self._device if stream is None else stream.device, stream):
                for h, r in zip(host, part):
                    h[off:off + n].copy_(r, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
                done.append(ev)
            off += n
        return host, done

    @staticmethod
    def _wait(host, done) -> list:
        for ev in done or ():
            ev.synchronize()
        return [t.numpy() for t in host]

    def _compute(self, fn, pages) -> list:
        """``fn`` over host pages on every entry, its result on the host
        now (the retry and fallback paths)."""
        return self._wait(*self._to_host(self._each(fn, self._upload(pages))))

    def _dispatch(self, pages, *, chunked: bool) -> None:
        host = self._host_u8(pages) if self._sparse else None
        self._enqueue(self._upload(host if host is not None else pages), host, chunked=chunked)

    def _enqueue(self, parts: list, host, *, chunked: bool) -> None:
        if self._sparse:
            k = self._k_next
            run = self._run_sparse_chunk if chunked else self._run_sparse
            res = self._each(lambda pipe, pages: run(pipe, pages, k), parts)
            self._inflight.append(_Inflight(chunked, k, *self._to_host(res), host))
        else:
            res = self._each(self._run_chunk if chunked else self._run, parts)
            self._inflight.append(_Inflight(chunked, 0, *self._to_host(res), None))

    def _observe_counts(self, counts: np.ndarray) -> None:
        """Track recent changed-tile demand; pick the next dispatch's
        power-of-two budget with 25% headroom over the last 8 batches."""
        self._recent_counts.append(int(counts.max(initial=0)))
        target = max(1, int(max(self._recent_counts) * 1.25) + 1)
        self._k_next = next((lv for lv in self._k_levels if lv >= target), self._k_levels[-1])

    @property
    def wire_bytes(self) -> int:
        """Cumulative sparse-result device-to-host bytes."""
        return self._wire_bytes

    # -- push-style API ------------------------------------------------------
    def submit(self, pages) -> None:
        """Queue one batch ((N,H,W,3): uint8 in [0, 255], the cheap form,
        or float in [0, 1]); returns without waiting for the device. With
        ``chunk=k`` every k-th submit dispatches the k buffered batches;
        :meth:`flush`/:meth:`drain` push out a partial tail. :meth:`collect`
        returns the results."""
        if self._chunk == 1:
            self._dispatch(pages, chunked=False)
            return
        self._pending.append(np.asarray(pages))
        if len(self._pending) == self._chunk:
            stack, self._pending = np.stack(self._pending), []
            self._dispatch(stack, chunked=True)

    def flush(self) -> None:
        """Dispatch buffered submits short of a full chunk, one by one."""
        pending, self._pending = self._pending, []
        for pages in pending:
            self._dispatch(pages, chunked=False)

    def ready(self) -> bool:
        """True if :meth:`collect` will not stall the pipeline (the oldest
        result has ``depth`` newer batches queued behind it)."""
        return len(self._inflight) > self._depth

    def _materialize_sparse(self, buf: np.ndarray, host: np.ndarray,
                            k_used: int) -> Tuple[np.ndarray, np.ndarray]:
        # sparse_pack clamps its slots to the page's tile count: unflatten
        # with the same clamp
        h, w = host.shape[1:3]
        t = (h // self._tile) * (w // self._tile)
        k = min(k_used, t)
        self._wire_bytes += buf.nbytes
        packed = sparse_unflatten(buf, max_tiles=k, tile=self._tile)
        # count is the TRUE changed-tile count, even past k: feed the
        # budget before any fallback
        self._observe_counts(packed.count)
        clean, mask, overflow = sparse_recompose(host, packed, tile=self._tile)
        kmax = min(self._sparse, t)
        if overflow.any() and k < kmax:
            # the adaptive budget undershot: redo at the largest budget,
            # still on the sparse wire
            (buf2,) = self._compute(
                lambda pipe, pages: self._run_sparse(pipe, pages, self._sparse), host)
            self._wire_bytes += buf2.nbytes
            packed2 = sparse_unflatten(buf2, max_tiles=kmax, tile=self._tile)
            clean2, mask2, overflow2 = sparse_recompose(host, packed2, tile=self._tile)
            clean[overflow], mask[overflow] = clean2[overflow], mask2[overflow]
            overflow = overflow & overflow2
        if overflow.any():
            # more changed tiles than even the largest budget: redo the
            # batch densely and keep the overflowed pages
            dc, dm = self._compute(self._run, host)
            clean[overflow], mask[overflow] = dc[overflow], dm[overflow]
        return clean, mask

    def collect(self) -> Tuple[np.ndarray, np.ndarray] | None:
        """The oldest in-flight result as numpy arrays, or None. A chunked
        dispatch is read back in one copy and handed out one logical
        batch at a time."""
        if self._done:
            return self._done.popleft()
        if not self._inflight:
            return None
        chunked, k_used, host, done, pages_u8 = self._inflight.popleft()
        res = self._wait(host, done)
        if k_used:
            (bufs,) = res
            if not chunked:
                return self._materialize_sparse(bufs, pages_u8, k_used)
            for b, h in zip(bufs, pages_u8):
                self._done.append(self._materialize_sparse(b, h, k_used))
            return self._done.popleft()
        clean, mask = res
        if not chunked:
            return clean, mask
        for i in range(1, clean.shape[0]):
            self._done.append((clean[i], mask[i]))
        return clean[0], mask[0]

    def drain(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        self.flush()
        while self._inflight or self._done:
            yield self.collect()

    # -- pull-style API ------------------------------------------------------
    def serve(self, host_batches: Iterable, *,
              prefetch: int = 2) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Host batches -> (clean, mask) numpy pairs, pipelined, in order.

        ``host_batches`` yields (N,H,W,3) arrays (uint8, or float in
        [0, 1]) or dicts with an ``"image"`` key. With ``chunk=k``, k
        consecutive batches are stacked on the host and ride one dispatch
        and one result read; a tail short of k goes batch by batch.
        """
        host_q: collections.deque = collections.deque()  # sparse paste canvases

        def _images():
            buf = []
            for b in host_batches:
                img = np.asarray(b["image"] if isinstance(b, dict) else b)
                if self._sparse:
                    img = self._host_u8(img)
                if self._chunk == 1:
                    host_q.append(img)
                    yield {"image": img}
                    continue
                buf.append(img)
                if len(buf) == self._chunk:
                    stack, buf = np.stack(buf), []
                    host_q.append(stack)
                    yield {"image": stack}
            for img in buf:
                host_q.append(img)
                yield {"image": img}

        pf = DevicePrefetcher(_images(), device=self._device, depth=prefetch, mesh=self._mesh)
        try:
            for batch in pf:
                img = [batch["image"]] if self._mesh is None else [b["image"] for b in batch]
                host = host_q.popleft()
                chunked = self._chunk > 1 and host.ndim == 5
                self._enqueue(img, host if self._sparse else None, chunked=chunked)
                while self.ready() and self._inflight:
                    yield self.collect()
                while self._done:
                    yield self._done.popleft()
            while self._inflight or self._done:
                yield self.collect()
        finally:
            pf.close()
