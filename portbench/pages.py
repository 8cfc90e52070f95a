"""The benchmark's traffic engines: frozen copies of the port's native page
and hole-mask generators (``native/pagegen.cpp``, ``native/maskgen.cpp``,
``native/glyph_atlas.npz``), bound with ctypes.

The libraries are built by ``make`` into ``native/build/`` beside this
file at first use, a fixed directory inside the checkout, so only the
first run in a checkout compiles. There is no fallback: traffic that
changed with the build would not be the same traffic.

Seeds: a run's ``--seed`` and a stream name give every page its own
64-bit engine seed through ``numpy.random.SeedSequence``, so any whole
number (past 32 bits too) makes the same pages on every machine.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

NATIVE = Path(__file__).resolve().parent / "native"
BUILD = NATIVE / "build"
ATLAS = NATIVE / "glyph_atlas.npz"
_SIZES = tuple(range(12, 48))  # the atlas's font sizes

_lock = threading.Lock()
_libs: dict = {}
_atlas = None


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name in _libs:
            return _libs[name]
        path = BUILD / f"lib{name}.so"
        if not path.exists():
            proc = subprocess.run(["make", "-C", str(NATIVE), f"build/lib{name}.so"],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"building {path} failed:\n{proc.stdout}\n{proc.stderr}")
        lib = ctypes.CDLL(str(path))
        u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
        i, d = ctypes.c_int, ctypes.c_double
        if name == "pagegen":
            lib.synth_page_batch.argtypes = [u8p, u8p, i, i, i, i,
                                             ctypes.POINTER(ctypes.c_uint64), u8p, i32p, i32p,
                                             i, i, i, i, d]
            lib.synth_page_batch.restype = None
        else:
            lib.random_stroke_mask_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float), i, i, i, ctypes.POINTER(ctypes.c_uint64),
                i, i, i, i, i, i, d, d, i, i, d, d, i]
            lib.random_stroke_mask_batch.restype = None
        _libs[name] = lib
        return lib


def _glyphs():
    global _atlas
    with _lock:
        if _atlas is None:
            with np.load(ATLAS) as f:
                _atlas = tuple(np.ascontiguousarray(f[k]) for k in ("bits", "meta", "sizes"))
        return _atlas


def engine_seeds(seed: int, stream: str, count: int) -> np.ndarray:
    """``count`` 64-bit engine seeds for the named stream of run ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), zlib.crc32(stream.encode())])
    return ss.generate_state(count, dtype=np.uint64)


def synth_pages_u8(seeds, size=(512, 512), *, mode: str = "seg", num_runs=(3, 10),
                   vertical_prob: float = 0.4):
    """(pages (B, H, W, 3) uint8, text mask (B, H, W, 1) uint8 0/1), one page
    per engine seed. mode 'seg': the text composited onto the page; mode
    'inpaint': the clean page (the mask still marks the text layer)."""
    lib = _lib("pagegen")
    bits, meta, sizes = _glyphs()
    seeds = np.ascontiguousarray(np.asarray(seeds, dtype=np.uint64))
    h, w = size
    img = np.empty((len(seeds), h, w, 3), dtype=np.uint8)
    mask = np.empty((len(seeds), h, w), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.synth_page_batch(
        img.ctypes.data_as(u8p), mask.ctypes.data_as(u8p), len(seeds), h, w,
        0 if mode == "seg" else 1, seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        bits.ctypes.data_as(u8p), meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(_SIZES),
        meta.shape[0] // len(_SIZES), int(num_runs[0]), int(num_runs[1]), float(vertical_prob))
    return img, mask[..., None]


def hole_masks(seeds, size=(512, 512), *, num_strokes=(2, 6), stroke_steps=(8, 24),
               radius=(6, 24), step_len=(8.0, 32.0), num_rects=(1, 4),
               rect_frac=(0.05, 0.25), with_rects: bool = True) -> np.ndarray:
    """Irregular hole masks (B, H, W, 1) float32, 1 = valid, one per seed."""
    lib = _lib("maskgen")
    seeds = np.ascontiguousarray(np.asarray(seeds, dtype=np.uint64))
    h, w = size
    out = np.empty((len(seeds), h, w), dtype=np.float32)
    lib.random_stroke_mask_batch(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(seeds), h, w,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        int(num_strokes[0]), int(num_strokes[1]), int(stroke_steps[0]), int(stroke_steps[1]),
        int(radius[0]), int(radius[1]), float(step_len[0]), float(step_len[1]),
        int(num_rects[0]), int(num_rects[1]), float(rect_frac[0]), float(rect_frac[1]),
        1 if with_rects else 0)
    return out[..., None]
