"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use each source is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``. The build
directory is keyed by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses its library. There is no fallback:
a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
CUDA_HOME = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# What the last call of ``load_library`` did: seconds spent in nvcc (0.0
# when the library was already built) and nvcc's ptxas report.
last_build = {"seconds": 0.0, "log": "", "path": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = CUDA_HOME / "bin" / "nvcc"
    if cuda_nvcc.exists():
        return str(cuda_nvcc)
    raise RuntimeError(f"nvcc not found on PATH or in {cuda_nvcc.parent}: cannot build the CUDA kernels")


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/<hash>/libtsii_kernels.so``."""
    srcs = _sources()
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS:
        digest.update(flag.encode())
    for src in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_DIR / digest.hexdigest()[:16]
    lib_path = out_dir / "libtsii_kernels.so"
    last_build.update(seconds=0.0, log="", path=str(lib_path))
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(srcs, objs))
    ]
    logs = []
    for cmd, proc in procs:  # wait for every compile, so none outlives a failure
        out, _ = proc.communicate()
        logs.append((cmd, proc.returncode, out))
    for cmd, code, out in logs:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{out}")
    tmp = out_dir / f"libtsii_kernels.{tag}.so"
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see a partial file
    last_build.update(seconds=time.perf_counter() - t0, log="".join(out for _, _, out in logs))
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with its C
    signatures declared (every pointer and the stream as ``c_void_p``)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tsii_pconv_k1.argtypes = [ptr] * 6 + [i32] * 15 + [ptr]
        lib.tsii_pconv_k1.restype = i32
        lib.tsii_pconv_k2.argtypes = [ptr] * 6 + [i32] * 12 + [ptr]
        lib.tsii_pconv_k2.restype = i32
        lib.tsii_stem_dx.argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
        lib.tsii_stem_dx.restype = i32
        lib.tsii_stem_pool.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.tsii_stem_pool.restype = i32
        lib.tsii_error_string.argtypes = [i32]
        lib.tsii_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launcher."""
    if code != 0:
        msg = lib.tsii_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
