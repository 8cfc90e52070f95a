"""Device mesh and batch sharding for serving: the port's distribution layer.

Counterpart of the serving part of
``text_segmentation_image_inpainting_tpu/parallel/mesh.py``. A mesh is a
single-process ``(data, model)`` grid of ``torch.device`` entries with
``model`` always 1 here: a batch splits along its leading axis over the
``data`` entries, each entry runs its shard on its own device and CUDA
stream, and the results are gathered back in page order
(``shard_batch`` / ``gather``, the counterparts of ``batch_sharding`` +
``shard_batch`` and of reading a sharded result back).

An entry may repeat a device: ``platform="cpu"`` gives n entries of the
CPU (as JAX's virtual CPU devices in its tests), and a ``devices`` list
may name one card several times, so that one GPU holds a mesh of 2 or 4
shards, each on its own stream. ``make_mesh()`` without ``devices``
never repeats a device on its own. Modules are replicated once per
distinct device (``replicate``); repeated entries share the module.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) grid of devices. ``devices`` is a 2-D object array."""

    devices: np.ndarray
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> List[torch.device]:
        """The entries in row-major order (the data axis, model 1)."""
        return list(self.devices.ravel())


def _available(platform: str | None) -> List[torch.device]:
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"unknown platform {platform!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass platform='cpu' for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, *, devices: Sequence[Any] | None = None,
              platform: str | None = None, model_parallel: int = 1) -> Mesh:
    """(data, model) mesh over the available devices (model 1).

    ``devices`` may repeat a device. Without it, the CUDA devices (the
    default; ``platform="cuda"``) or, with ``platform="cpu"``,
    ``n_devices`` entries of the CPU (one by default). Asking for more CUDA
    devices than there are raises: a device is never repeated unasked.
    """
    if model_parallel != 1:
        raise ValueError("the port's mesh has model_parallel 1 (no tensor parallelism)")
    if devices is None:
        devices = _available(platform)
        if platform == "cpu":
            devices = devices * (n_devices or 1)
        elif n_devices is not None and n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked, {len(devices)} available; pass "
                             f"devices=[...] to place several entries on one card")
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    arr = np.empty((len(devices), 1), dtype=object)
    for i, d in enumerate(devices):
        arr[i, 0] = d
    return Mesh(arr)


def make_mesh_for_batch(batch_size: int, *, devices: Sequence[Any] | None = None,
                        platform: str | None = None) -> Mesh:
    """``make_mesh`` with the data axis narrowed to divide ``batch_size``:
    gcd(n_data, batch_size) entries, the first ones, with JAX's note when
    it narrows."""
    full = make_mesh(devices=devices, platform=platform)
    n_data = full.shape[DATA_AXIS]
    d = math.gcd(n_data, batch_size) if batch_size > 0 else n_data
    if d < n_data:
        print(
            f"note: batch {batch_size} not divisible by {n_data} data-parallel "
            f"devices; using {d}-way DP over the first {d} devices"
        )
    return make_mesh(devices=full.device_list[:d])


def distinct_devices(mesh: Mesh) -> List[torch.device]:
    """The mesh's devices, each once, in order of first entry."""
    out: List[torch.device] = []
    for d in mesh.device_list:
        if d not in out:
            out.append(d)
    return out


_STREAMS: dict = {}
_POOL: list = []
_LOCK = threading.Lock()


def entry_streams(devices: Sequence[torch.device]) -> list:
    """A CUDA stream per entry (None for a CPU entry): the k-th entry on a
    device gets that device's k-th stream, the same one on every call. The
    caching allocator keeps freed blocks per stream, so a fresh stream per
    call would find its pool empty and ``cudaMalloc`` every tensor."""
    seen: dict = {}
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            out.append(None)
            continue
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        k = seen[d] = seen.get(d, -1) + 1
        with _LOCK:
            if (d, k) not in _STREAMS:
                _STREAMS[(d, k)] = torch.cuda.Stream(d)
            out.append(_STREAMS[(d, k)])
    return out


def host_pool() -> ThreadPoolExecutor:
    """The host threads that run mesh entries, kept across calls: torch
    keeps caches per thread (cuDNN's execution plans among them), so a
    fresh thread per call would build them again at every conv."""
    with _LOCK:
        if not _POOL:
            _POOL.append(ThreadPoolExecutor(max_workers=64, thread_name_prefix="mesh-entry"))
        return _POOL[0]


@contextlib.contextmanager
def on_stream(device: torch.device, stream: torch.cuda.Stream | None):
    """Make ``device`` and ``stream`` current (nothing for a CPU entry)."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def replicate(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``module`` itself where its parameters already live on ``device``,
    else a deep copy moved there (a replica for one more device)."""
    param = next(module.parameters(), None)
    if param is None or param.device == torch.device(device):
        return module
    return copy.deepcopy(module).to(device)


def _split(x, n: int) -> list:
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not split over {n} mesh entries")
    size = x.shape[0] // n
    return [x[i * size:(i + 1) * size] for i in range(n)]


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def shard_batch(mesh: Mesh, batch) -> list:
    """Split a batch (a tensor or array, or a dict of them) along its
    leading axis over the mesh's entries: entry i's part of every leaf on
    entry i's device. Host data is uploaded through pinned memory without
    blocking (``data.pipeline.upload``); a CUDA tensor is copied on the
    current stream. Returns one batch of the same structure per entry."""
    from text_segmentation_image_inpainting_tpu_torch.data.pipeline import upload

    devs = mesh.device_list
    split = _map(lambda x: _split(x, len(devs)), batch)

    def part(i, leaf_parts):
        x = leaf_parts[i]
        if not isinstance(x, torch.Tensor):
            return upload(x, devs[i])
        return x if x.device == devs[i] else x.to(devs[i], non_blocking=True)

    def pick(i, tree):
        if isinstance(tree, dict):
            return {k: pick(i, v) for k, v in tree.items()}
        return part(i, tree)

    return [pick(i, split) for i in range(len(devs))]


def gather(parts: Sequence[torch.Tensor], device: Any = None) -> torch.Tensor:
    """Concatenate per-entry results along the leading axis (page order) on
    ``device`` (default: the first part's)."""
    device = torch.device(device) if device is not None else parts[0].device
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=0)
