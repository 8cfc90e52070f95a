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
distinct device (``replicate``); repeated entries share the module. An
index-less ``"cuda"`` entry is the current CUDA device.

Training (the counterpart of the training half: ``batch_sharding``,
``stacked_batch_sharding``, ``replicated``, ``initialize_distributed``,
``make_hybrid_mesh``) runs one process per device, ``torch.distributed``'s
idiom: a *rank mesh* holds ranks in place of devices (``Mesh.ranks``), the
process group over them, and each rank's device. JAX's global batch is
every rank's host batch (each draws the same pages from the seed), of
which a rank uploads its rows only (``shard_batch``,
``make_array_from_process_local_data``): the rows ``batch_sharding``
gives it, dcn-major then data, as ``P((dcn, data))`` lays them out. A
step over a rank mesh runs under ``Mesh.data_parallel()``
(``ops/collectives.py``), where BatchNorm and the loss take the global
batch's sums and the gradients are summed over the ranks: the math of
JAX's global-batch step.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import os
import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices: (data, model), or (dcn, data, model) for a hybrid
    mesh. ``devices`` is an object array of ``torch.device``.

    A rank mesh (``ranks`` set) is one process per entry: ``ranks`` holds
    each entry's rank in the default group, ``devices`` each rank's device
    (on its own host) and ``group`` the process group over the ranks."""

    devices: np.ndarray
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)
    ranks: np.ndarray | None = None
    group: Any = None

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> List[torch.device]:
        """The entries in row-major order (dcn, then data; model 1)."""
        return list(self.devices.ravel())

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def position(self, rank: int | None = None) -> int | None:
        """A rank's entry in row-major order (dcn-major, then data): the
        block of a sharded batch it holds. None for a rank outside the
        mesh; this process's rank by default."""
        if self.ranks is None:
            raise ValueError("a device mesh has no ranks: this is a rank mesh's question")
        rank = _rank() if rank is None else rank
        hits = np.flatnonzero(self.ranks.ravel() == rank)
        return int(hits[0]) if hits.size else None

    @property
    def local_device(self) -> torch.device:
        """This rank's device (a rank mesh)."""
        return self.device_list[self.position()]

    def data_parallel(self):
        """The scope of one global-batch step over this rank mesh
        (``ops/collectives.py::data_parallel``); nothing for a device mesh."""
        if self.ranks is None:
            return contextlib.nullcontext()
        from text_segmentation_image_inpainting_tpu_torch.ops.collectives import data_parallel

        return data_parallel(self.group, self.size)

    @property
    def backend(self) -> str | None:
        """The process group's backend ('nccl', 'gloo'); None for a device mesh."""
        if self.ranks is None:
            return None
        import torch.distributed as dist

        return str(dist.get_backend(self.group))


def _available(platform: str | None) -> List[torch.device]:
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"unknown platform {platform!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass platform='cpu' for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _normalize(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; an index-less ``"cuda"`` is the
    current CUDA device, so that one card never counts as two."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


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
    devices = [_normalize(d) for d in devices]
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
    it narrows. In an initialised ``torch.distributed`` world of more than
    one process (and no ``devices`` or ``platform`` given), a rank mesh
    over the first gcd(world, batch_size) ranks (``make_rank_mesh``); a
    rank beyond them is outside the mesh (``Mesh.position`` is None)."""
    world = _world()
    if devices is None and platform is None and world > 1:
        d = _narrowed(world, batch_size)
        return make_rank_mesh(list(range(d)))
    full = make_mesh(devices=devices, platform=platform)
    d = _narrowed(full.shape[DATA_AXIS], batch_size)
    return make_mesh(devices=full.device_list[:d])


def _narrowed(n_data: int, batch_size: int) -> int:
    d = math.gcd(n_data, batch_size) if batch_size > 0 else n_data
    if d < n_data:
        print(
            f"note: batch {batch_size} not divisible by {n_data} data-parallel "
            f"devices; using {d}-way DP over the first {d} devices"
        )
    return d


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
        d = _normalize(d)
        if d.type != "cuda":
            out.append(None)
            continue
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
    if param is None or param.device == _normalize(device):
        return module
    return copy.deepcopy(module).to(device)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Which rows of a global batch each mesh entry holds: the batch axis
    ``axis`` (0, or 1 for a stacked ``(k, batch, ...)`` super-batch) cut
    into ``mesh.size`` equal contiguous blocks, entry i (row-major:
    dcn-major, then data) holding block i, as JAX's ``P((dcn, data))``
    and ``P(None, (dcn, data))`` lay them out."""

    mesh: Mesh
    axis: int = 0

    def block(self, n: int, position: int) -> slice:
        """The rows of an axis of length ``n`` that entry ``position`` holds."""
        parts = self.mesh.size
        if n % parts:
            raise ValueError(f"batch of {n} does not split over {parts} mesh entries")
        size = n // parts
        return slice(position * size, (position + 1) * size)

    def local(self, x, position: int | None = None):
        """``x``'s block for entry ``position`` (this rank's by default)."""
        position = self.mesh.position() if position is None else position
        return x[(slice(None),) * self.axis + (self.block(x.shape[self.axis], position),)]

    def local_shape(self, global_shape: Sequence[int]) -> tuple:
        shape = list(global_shape)
        cut = self.block(shape[self.axis], 0)
        shape[self.axis] = cut.stop - cut.start
        return tuple(shape)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every entry holds the whole value (parameters, optimizer state)."""

    mesh: Mesh

    def place(self, module: torch.nn.Module) -> torch.nn.Module:
        """``module`` on this rank's device with the mesh's first rank's
        parameters and buffers (one broadcast per dtype), as JAX's
        ``device_put(state, replicated(mesh))`` places one host copy. A
        device mesh's entries share the module: returned as it is."""
        if self.mesh.ranks is None:
            return module
        import torch.distributed as dist

        from text_segmentation_image_inpainting_tpu_torch.ops.collectives import flat_apply_

        module = module.to(self.mesh.local_device)
        src = int(self.mesh.ranks.ravel()[0])
        flat_apply_([*module.parameters(), *module.buffers()],
                    lambda flat: dist.broadcast(flat, src=src, group=self.mesh.group))
        return module


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Shard the leading (batch) axis over the mesh's entries (dcn and data
    on a hybrid mesh)."""
    return BatchSharding(mesh, 0)


def stacked_batch_sharding(mesh: Mesh) -> BatchSharding:
    """A multi-step super-batch ``(k, batch, ...)``: the step axis whole
    (the steps run in turn), the batch axis as ``batch_sharding``."""
    return BatchSharding(mesh, 1)


def replicated(mesh: Mesh) -> Replicated:
    """Whole on every entry (parameters, optimizer state)."""
    return Replicated(mesh)


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _place(x, device: torch.device):
    if not isinstance(x, torch.Tensor):
        from text_segmentation_image_inpainting_tpu_torch.data.pipeline import upload

        return upload(x, device)
    return x if x.device == device else x.to(device, non_blocking=True)


def shard_batch(mesh: Mesh, batch, sharding: BatchSharding | None = None):
    """Place a batch (a tensor or array, or a dict of them) sharded on the
    mesh, along ``sharding``'s axis (``batch_sharding(mesh)`` by default).
    Host data is uploaded through pinned memory without blocking
    (``data.pipeline.upload``); a CUDA tensor is copied on the current
    stream.

    A device mesh: one batch of the same structure per entry, entry i's
    block of every leaf on entry i's device. A rank mesh: this rank's
    block of the global batch on its device, as JAX's ``device_put`` of
    the host batch leaves each process its shards."""
    sharding = batch_sharding(mesh) if sharding is None else sharding
    if mesh.ranks is not None:
        device = mesh.local_device
        return _map(lambda x: _place(sharding.local(x), device), batch)
    devs = mesh.device_list
    return [_map(lambda x, i=i: _place(sharding.local(x, i), devs[i]), batch)
            for i in range(len(devs))]


def make_array_from_process_local_data(sharding: BatchSharding, local_data,
                                       global_shape: Sequence[int] | None = None) -> torch.Tensor:
    """This rank's block of a global array, from the rows it already holds
    (JAX's ``make_array_from_process_local_data`` on one device per
    process): ``local_data`` on the rank's device, its shape checked
    against the block of ``global_shape`` that the rank holds."""
    mesh = sharding.mesh
    if mesh.ranks is None:
        raise ValueError("make_array_from_process_local_data takes a rank mesh's sharding")
    if global_shape is not None and tuple(local_data.shape) != sharding.local_shape(global_shape):
        raise ValueError(f"local data {tuple(local_data.shape)} is not rank {_rank()}'s block "
                         f"{sharding.local_shape(global_shape)} of {tuple(global_shape)}")
    return _place(local_data, mesh.local_device)


def gather(parts: Sequence[torch.Tensor], device: Any = None) -> torch.Tensor:
    """Concatenate per-entry results along the leading axis (page order) on
    ``device`` (default: the first part's)."""
    device = torch.device(device) if device is not None else parts[0].device
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=0)


# -- one process per device: the process group and rank meshes -------------

_RANK_DEVICE: list = []  # this process's device, once initialize_distributed ran
_RANK_INFO: list = []    # every rank's (node, device), gathered once


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank_device() -> torch.device | None:
    """This rank's device after ``initialize_distributed``, else None."""
    return _RANK_DEVICE[0] if _RANK_DEVICE else None


def initialize_distributed(coordinator_address: str | None = None, *,
                           num_processes: int | None = None, process_id: int | None = None,
                           local_device_ids: Sequence[int] | None = None,
                           platform: str | None = None,
                           backend: str | None = None) -> torch.device:
    """Join (or bootstrap) the process group; returns this rank's device.

    With ``coordinator_address`` ("host:port"): ``init_process_group`` at
    ``tcp://<address>`` with ``num_processes`` ranks as rank
    ``process_id``. Without it, torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK), as JAX takes a pod's. The device: the
    CPU for ``platform="cpu"``, else CUDA device ``local_device_ids[0]``,
    else ``LOCAL_RANK``, else rank modulo the visible devices; a CUDA
    device becomes the current one. The backend is nccl for CUDA and gloo
    for the CPU unless ``backend`` names one (gloo also takes CUDA tensors,
    and several ranks on one card, which nccl refuses). A second call
    returns the device of the first."""
    import torch.distributed as dist

    if dist.is_initialized():
        if not _RANK_DEVICE:
            raise RuntimeError("torch.distributed was initialised outside initialize_distributed")
        return _RANK_DEVICE[0]
    if platform not in (None, "cuda", "gpu", "cpu"):
        raise ValueError(f"unknown platform {platform!r}: 'cuda' or 'cpu'")
    use_cuda = platform != "cpu"
    if use_cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass platform='cpu' for CPU ranks")
    kw = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                  rank=process_id)
    dist.init_process_group(backend or ("nccl" if use_cuda else "gloo"), **kw)
    if not use_cuda:
        device = torch.device("cpu")
    else:
        if local_device_ids:
            index = int(local_device_ids[0])
        elif "LOCAL_RANK" in os.environ:
            index = int(os.environ["LOCAL_RANK"])
        else:
            index = dist.get_rank() % torch.cuda.device_count()
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    _RANK_DEVICE[:] = [device]
    _RANK_INFO.clear()
    return device


def _node() -> str:
    """This process's host: torchrun's node (GROUP_RANK, or the rank over
    LOCAL_WORLD_SIZE) where set, else the host name."""
    if "GROUP_RANK" in os.environ:
        return f"node {os.environ['GROUP_RANK']}"
    if "LOCAL_WORLD_SIZE" in os.environ:
        return f"node {_rank() // int(os.environ['LOCAL_WORLD_SIZE'])}"
    return socket.gethostname()


def _rank_info() -> list:
    """Every rank's (node, device), gathered over the default group once."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a rank mesh needs an initialised process group "
                           "(initialize_distributed)")
    if not _RANK_INFO:
        mine = (_node(), str(rank_device() or torch.device("cpu")))
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, mine)
        _RANK_INFO[:] = out
    return _RANK_INFO


def _group_for(ranks: Sequence[int]):
    import torch.distributed as dist

    if list(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(list(ranks))  # every rank of the world takes part


def _rank_mesh(ranks: np.ndarray, axis_names: tuple) -> Mesh:
    info = _rank_info()
    devices = np.empty(ranks.shape, dtype=object)
    for idx, r in np.ndenumerate(ranks):
        devices[idx] = torch.device(info[int(r)][1])
    return Mesh(devices, axis_names, ranks=ranks,
                group=_group_for([int(r) for r in ranks.ravel()]))


def make_rank_mesh(ranks: Sequence[int] | None = None) -> Mesh:
    """A (data, model) rank mesh over ``ranks`` of the default group (all
    by default; model 1). Every rank of the world must call it, since a
    subgroup's creation is collective."""
    ranks = list(range(_world())) if ranks is None else [int(r) for r in ranks]
    if not ranks:
        raise ValueError("a mesh needs at least one rank")
    return _rank_mesh(np.asarray(ranks, dtype=np.int64).reshape(len(ranks), 1),
                      (DATA_AXIS, MODEL_AXIS))


def make_hybrid_mesh(*, model_parallel: int = 1, ranks: Sequence[int] | None = None) -> Mesh:
    """(dcn, data, model) rank mesh: the outer axis spans hosts, the inner
    ones stay inside a host. Ranks are grouped by node (``_node``: torchrun's
    GROUP_RANK or LOCAL_WORLD_SIZE, else the host name), in the spirit of
    JAX's grouping by ``process_index``; hosts in the order of their first
    rank. ``batch_sharding`` folds dcn and data into the batch axis, so the
    gradient sum spans both. Every rank of the world must call it."""
    if model_parallel != 1:
        raise ValueError("the port's mesh has model_parallel 1 (no tensor parallelism)")
    ranks = list(range(_world())) if ranks is None else [int(r) for r in ranks]
    info = _rank_info()
    nodes: dict = {}
    for r in sorted(ranks):
        nodes.setdefault(info[r][0], []).append(r)
    per = len(ranks) // len(nodes)
    if any(len(v) != per for v in nodes.values()):
        raise ValueError(f"hosts hold unequal numbers of ranks: "
                         f"{ {k: len(v) for k, v in nodes.items()} }")
    arr = np.asarray(list(nodes.values()), dtype=np.int64).reshape(len(nodes), per, 1)
    return _rank_mesh(arr, (DCN_AXIS, DATA_AXIS, MODEL_AXIS))
