"""Page batches for segmentation and inpainting training.

Counterpart of ``text_segmentation_image_inpainting_tpu/data/pipeline.py``
(``PageSource``, ``list_image_paths``, ``make_dataset``).
Sample ``idx`` is drawn from ``np.random.default_rng((seed << 32) ^ idx)``
as in JAX, by the port's own copy of the JAX package's generators
(``data/text_overlay.py``, ``data/native_masks.py``, ``data/masks.py``,
``data/native_pages.py`` and their C++ sources under ``data/native/``:
numpy, PIL and ctypes), imported where they are used, so the two
packages draw the same pages from the same seeds. Batches are taken in
index order and stacked by hand: there is no grain shuffle.
``make_page_stream_u8`` draws serving pages from the native engine, and
``DevicePrefetcher`` uploads host batches on a CUDA stream of its own
from a worker thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
from typing import Any, Iterator, Sequence

import numpy as np
import torch

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


@dataclasses.dataclass
class PageSource:
    """Random-access training pairs:

      kind='seg'     -> (page with text, text mask)
      kind='inpaint' -> (clean page, hole mask), mask 1 = valid

    With ``paths``, real images are decoded with PIL (random crop, an
    aspect-preserving upscale when too small, random flip) and get the
    same synthetic text or holes.
    """

    kind: str = "seg"
    size: tuple[int, int] = (512, 512)
    length: int = 1 << 16
    seed: int = 0
    paths: Sequence[str] | None = None

    def __post_init__(self):
        if self.kind not in ("seg", "inpaint"):
            raise ValueError(f"kind {self.kind!r}: 'seg' or 'inpaint'")

    def __len__(self) -> int:
        return self.length

    def _load_base(self, rng: np.random.Generator):
        from PIL import Image

        img = Image.open(self.paths[int(rng.integers(0, len(self.paths)))]).convert("RGB")
        w, h = img.size
        th, tw = self.size
        if w < tw or h < th:
            scale = max(tw / w, th / h)
            img = img.resize((max(tw, round(w * scale)), max(th, round(h * scale))),
                             Image.BILINEAR)
            w, h = img.size
        x0 = int(rng.integers(0, w - tw + 1))
        y0 = int(rng.integers(0, h - th + 1))
        arr = np.asarray(img.crop((x0, y0, x0 + tw, y0 + th)), dtype=np.float32) / 255.0
        if rng.random() < 0.5:  # horizontal flip
            arr = arr[:, ::-1]
        return np.ascontiguousarray(arr)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng((self.seed << 32) ^ int(idx))
        if self.kind == "seg":
            if not self.paths:
                from text_segmentation_image_inpainting_tpu_torch.data.text_overlay import (
                    segmentation_sample,
                )

                img, mask = segmentation_sample(rng, self.size)
            else:
                from text_segmentation_image_inpainting_tpu_torch.data.text_overlay import overlay_text

                img, mask = overlay_text(self._load_base(rng), rng)
            return {"image": img, "mask": mask}
        if not self.paths:
            from text_segmentation_image_inpainting_tpu_torch.data.text_overlay import inpainting_sample

            img, mask = inpainting_sample(rng, self.size)
            return {"image": img, "mask": mask}
        from text_segmentation_image_inpainting_tpu_torch.data import native_masks
        from text_segmentation_image_inpainting_tpu_torch.data.text_overlay import overlay_text

        img = self._load_base(rng)
        if rng.random() < 0.5:  # text-shaped holes, the product case
            _, text_mask = overlay_text(img, rng)
            mask = (1.0 - text_mask).astype(np.float32)
        else:
            mask = native_masks.random_hole_masks([int(rng.integers(0, 2**63))], self.size)[0]
        return {"image": img, "mask": mask}


def list_image_paths(data_dir: str) -> list[str]:
    """Recursive, case-insensitive image scan for ``--data-dir``; raises
    ``SystemExit`` when nothing matches (a typo must not train on
    synthetic pages)."""
    paths = sorted(
        os.path.join(root, f)
        for root, _, files in os.walk(data_dir)
        for f in files
        if f.lower().endswith(IMAGE_EXTS)
    )
    if not paths:
        raise SystemExit(f"--data-dir {data_dir}: no image files found "
                         f"(extensions {', '.join(IMAGE_EXTS)}, case-insensitive)")
    return paths


def make_dataset(kind: str, *, batch_size: int = 8, size: tuple[int, int] = (512, 512),
                 seed: int = 0, paths: Sequence[str] | None = None,
                 start: int = 0) -> Iterator[dict]:
    """Infinite iterator of numpy batches {'image': (B,H,W,3), 'mask': (B,H,W,1)}.

    Pages come in index order from page ``start``: the stream from
    ``start = k`` is the stream from 0 with its first ``k`` pages
    skipped, which is how a resumed run continues where it stopped."""
    source = PageSource(kind=kind, size=tuple(size), seed=seed, paths=paths)
    i = start
    while True:
        samples = [source[(i + j) % len(source)] for j in range(batch_size)]
        i += batch_size
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def to_device(batch: dict, device) -> dict:
    """numpy batch -> float32 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in batch.items()}


def make_page_stream_u8(batch_size: int = 8, size: tuple[int, int] = (512, 512),
                        seed: int = 0) -> Iterator[dict]:
    """Infinite iterator of serving batches {'image': (B,H,W,3) uint8}.

    Batch ``i`` draws pages ``((seed + 1) << 40) ^ (i*B + j)`` from the
    native page engine in mode 'seg', as the JAX package does, so both
    packages stream the same bytes. Without the native engine (no C++
    compiler) it quantizes ``make_dataset('seg')``, which needs PIL.
    """
    from text_segmentation_image_inpainting_tpu_torch.data import native_pages

    if native_pages.available():
        def _native():
            i = 0
            while True:
                seeds = [((seed + 1) << 40) ^ (i + j) for j in range(batch_size)]
                img, _ = native_pages.synth_pages_u8(seeds, size, mode="seg")
                i += batch_size
                yield {"image": img}

        return _native()

    it = make_dataset("seg", batch_size=batch_size, size=size, seed=seed)
    return ({"image": np.round(b["image"] * 255.0).astype(np.uint8)} for b in it)


def _tree_map(fn, tree):
    """``fn`` over the array leaves of a dict / list / tuple batch."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def upload(x, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device`` without blocking the host.

    On CUDA the bytes are staged in pinned memory and copied
    ``non_blocking`` on the current stream (a pageable source would make
    the copy wait for the stream to drain); the caching host allocator
    keeps the staging block until the copy has run. A tensor already on
    ``device`` is returned as it is; on the CPU this is ``torch.as_tensor``.
    """
    if isinstance(x, torch.Tensor) and x.device == device:
        return x
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DevicePrefetcher:
    """Overlap host batch production and host-to-device copies with compute.

    A worker thread pulls host batches and uploads them, keeping at most
    ``depth`` uploaded batches queued. On CUDA each batch is copied on the
    prefetcher's own stream and an event is recorded after it;
    ``__next__`` makes the consumer's current stream wait on that event
    and marks each tensor as used there (``record_stream``), so the
    caching allocator does not hand the memory to the next upload while
    the consumer's kernels may still read it. On a CPU ``device`` the
    batches are only converted to tensors.

    With ``mesh`` (``parallel.make_mesh``), the counterpart of JAX's
    ``sharding``, each batch splits along its leading axis over the mesh's
    entries (``parallel.shard_batch``): ``__next__`` returns one batch per
    entry, each on its entry's device, copied on a stream of the
    prefetcher's per distinct device. With ``sharding``
    (``parallel.batch_sharding`` or ``stacked_batch_sharding`` of a mesh)
    the batches split along its axis instead; over a rank mesh each
    ``__next__`` is this rank's rows of the global host batch, uploaded on
    its device: every rank draws the same pages and uploads its own, as
    JAX's ``device_put`` of one global batch leaves each process its shards.

    A batch the worker fails on is raised once from ``__next__``, after
    which the iterator stops; ``close()`` stops the worker, drains the
    queue and joins the thread.
    """

    def __init__(self, host_iter: Iterator, device: Any = "cuda", depth: int = 2, mesh=None,
                 sharding=None):
        from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import distinct_devices

        self._it = host_iter
        self._sharding = sharding
        self._mesh = mesh = sharding.mesh if sharding is not None else mesh
        if mesh is None:
            self._device = torch.device(device)
        else:
            self._device = mesh.local_device if mesh.ranks is not None else mesh.device_list[0]
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._dead = False
        if mesh is None or mesh.ranks is not None:
            devices = [self._device]
        else:
            devices = distinct_devices(mesh)
        self._streams = [torch.cuda.Stream(d) for d in devices if d.type == "cuda"]
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        # bounded put, so that close() can stop a worker blocked on a full
        # queue (an infinite stream never returns to the loop's check)
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _upload(self, batch):
        from text_segmentation_image_inpainting_tpu_torch.parallel.mesh import shard_batch

        def place():
            if self._mesh is None:
                return _tree_map(lambda x: upload(x, self._device), batch)
            return shard_batch(self._mesh, batch, self._sharding)

        if not self._streams:
            return place(), None
        with contextlib.ExitStack() as ctx:
            for stream in self._streams:
                ctx.enter_context(torch.cuda.stream(stream))
            batch = place()
        done = []
        for stream in self._streams:
            ev = torch.cuda.Event()
            ev.record(stream)
            done.append((stream.device, ev))
        return batch, done

    def _worker(self) -> None:
        try:
            for batch in self._it:
                if self._stop.is_set() or not self._put(self._upload(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised once in __next__
            self._put(e)
            return
        self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        # a dead worker delivered its exception once and never sends the
        # end marker: later calls must not block on get()
        if self._dead:
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._dead = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._dead = True
            raise item
        batch, done = item
        if done is not None:
            for device, ev in done:
                torch.cuda.current_stream(device).wait_event(ev)
            _tree_map(lambda t: t.record_stream(torch.cuda.current_stream(t.device)), batch)
        return batch

    def close(self) -> None:
        self._stop.set()
        # drain, so a worker blocked mid-put finishes and drops its batches
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
