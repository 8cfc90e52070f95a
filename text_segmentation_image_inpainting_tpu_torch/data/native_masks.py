"""ctypes bindings for the native C++ mask rasterizer.

The port's own copy of
``text_segmentation_image_inpainting_tpu/data/native_masks.py``, built
from the port's ``data/native/`` sources.

Builds ``data/native/libmaskgen.so`` on first use (g++, one translation
unit, <1s) and falls back to the pure-numpy generators in
``data/masks.py`` if no compiler is available. Same defaults as the
numpy path; RNG differs (xorshift vs PCG) so masks are *statistically*
equivalent, not bit-identical (both draw strokes always and rectangles
with probability 0.5, with the same geometry parameter ranges).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "native")
_LIB_PATH = os.path.join(_DIR, "libmaskgen.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _DIR, "libmaskgen.so"],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except Exception:
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.random_stroke_mask_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int,
        ]
        lib.random_stroke_mask_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def random_hole_masks(
    seeds,
    size: tuple[int, int] = (512, 512),
    *,
    num_strokes=(2, 6),
    stroke_steps=(8, 24),
    radius=(6, 24),
    step_len=(8.0, 32.0),
    num_rects=(1, 4),
    rect_frac=(0.05, 0.25),
    with_rects: bool = True,
) -> np.ndarray:
    """Batched hole masks (B, H, W, 1) float32, 1 = valid. Native when
    possible, numpy fallback otherwise."""
    seeds = np.asarray(seeds, dtype=np.uint64)
    h, w = size
    lib = _load()
    if lib is None:
        from text_segmentation_image_inpainting_tpu_torch.data.masks import (
            random_rect_mask,
            random_stroke_mask,
        )

        def one(seed):
            r = np.random.default_rng(int(seed))
            m = random_stroke_mask(
                r, size, num_strokes=num_strokes, stroke_steps=stroke_steps,
                radius=radius, step_len=step_len,
            )
            if with_rects and r.random() < 0.5:
                m = m * random_rect_mask(r, size, num_rects=num_rects, rect_frac=rect_frac)
            return m

        return np.stack([one(s) for s in seeds])
    out = np.empty((len(seeds), h, w), dtype=np.float32)
    lib.random_stroke_mask_batch(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(seeds), h, w,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        int(num_strokes[0]), int(num_strokes[1]),
        int(stroke_steps[0]), int(stroke_steps[1]),
        int(radius[0]), int(radius[1]),
        float(step_len[0]), float(step_len[1]),
        int(num_rects[0]), int(num_rects[1]),
        float(rect_frac[0]), float(rect_frac[1]),
        1 if with_rects else 0,
    )
    return out[..., None]
