"""ctypes bindings for the native C++ synthetic page engine.

``data/native/pagegen.cpp`` renders the full training sample — the
procedural manga-ish page, the glyph-run text overlay, the composite,
and the exact text mask — in one C++ pass, producing uint8 directly
(the form serving ships and the device pipeline uploads). Glyph SHAPES
come from an atlas of the same default font the Python path uses,
prerendered with PIL and kept in ``data/glyph_atlas.npz`` (drawing a page
needs no PIL), so the text statistics match ``data/text_overlay.py``; only
the RNG stream differs (xorshift vs numpy PCG), making samples
*statistically* equivalent, not bit-identical.

The port's own copy of
``text_segmentation_image_inpainting_tpu/data/native_pages.py``: the same
code, built from the port's ``data/native/`` sources, so the two
packages draw the same pages from the same seeds. Falls back to the PIL
path when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "native")
_LIB_PATH = os.path.join(_DIR, "libpagegen.so")
_lock = threading.Lock()
_lib = None
_build_failed = False

# atlas covers the overlay_text font-size range [12, 48)
_SIZES = tuple(range(12, 48))
_atlas = None  # (bits u8, meta i32 (S*C,4), sizes i32)
ATLAS_PATH = os.path.join(os.path.dirname(__file__), "glyph_atlas.npz")


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
                    ["make", "-C", _DIR, "libpagegen.so"],
                    check=True, capture_output=True, timeout=120,
                )
            except Exception:
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.synth_page_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ]
        lib.synth_page_batch.restype = None
        _lib = lib
        return _lib


def render_atlas():
    """Prerender every (size, char) glyph with PIL into a flat alpha atlas
    + [offset, gw, gh, advance] metadata: (bits u8, meta i32 (S*C, 4),
    sizes i32). About 0.5 s. ``data/glyph_atlas.npz`` holds its result,
    so that pages can be drawn where PIL is not installed (the GPU host);
    ``python -m text_segmentation_image_inpainting_tpu_torch.data.native_pages``
    writes it anew, and a CPU test holds the file to this function."""
    from PIL import Image, ImageDraw

    from text_segmentation_image_inpainting_tpu_torch.data.text_overlay import (
        _CHARS, _font)

    chars = list(_CHARS)
    bits_parts: list[np.ndarray] = []
    meta = np.zeros((len(_SIZES) * len(chars), 4), dtype=np.int32)
    offset = 0
    for si, size in enumerate(_SIZES):
        font = _font(size)
        tile = max(8, int(size * 2))
        for ci, ch in enumerate(chars):
            img = Image.new("L", (tile, tile), 0)
            ImageDraw.Draw(img).text((0, 0), ch, fill=255, font=font)
            a = np.asarray(img, dtype=np.uint8)
            ys, xs = np.nonzero(a)
            if len(ys):
                gh = int(ys.max()) + 1
                gw = int(xs.max()) + 1
                g = np.ascontiguousarray(a[:gh, :gw])
            else:  # glyph the font can't render -> 1x1 empty
                gh = gw = 1
                g = np.zeros((1, 1), dtype=np.uint8)
            try:
                adv = int(round(font.getlength(ch)))
            except AttributeError:  # very old PIL
                adv = gw
            meta[si * len(chars) + ci] = (offset, gw, gh, max(1, adv))
            bits_parts.append(g.reshape(-1))
            offset += g.size
    bits = np.concatenate(bits_parts) if bits_parts else np.zeros(1, np.uint8)
    sizes = np.asarray(_SIZES, dtype=np.int32)
    return np.ascontiguousarray(bits), np.ascontiguousarray(meta), sizes


def _build_atlas():
    """The glyph atlas, read once from ``data/glyph_atlas.npz``."""
    global _atlas
    if _atlas is not None:
        return _atlas
    with _lock:
        if _atlas is None:
            with np.load(ATLAS_PATH) as f:
                _atlas = (f["bits"], f["meta"], f["sizes"])
        return _atlas


def available() -> bool:
    return _load() is not None


def synth_pages_u8(
    seeds,
    size: tuple[int, int] = (512, 512),
    *,
    mode: str = "seg",
    num_runs: tuple[int, int] = (3, 10),
    vertical_prob: float = 0.4,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched native synthesis.

    Returns (images (B,H,W,3) uint8, text_mask (B,H,W,1) uint8 0/1).
    mode='seg': text composited onto the page; mode='inpaint': clean
    page, mask still marks the text layer (callers make holes from it).
    Raises RuntimeError if the native library is unavailable — use
    ``available()`` to pre-check (callers fall back to the PIL path).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native pagegen unavailable")
    bits, meta, sizes = _build_atlas()
    seeds = np.ascontiguousarray(np.asarray(seeds, dtype=np.uint64))
    h, w = size
    b = len(seeds)
    img = np.empty((b, h, w, 3), dtype=np.uint8)
    mask = np.empty((b, h, w), dtype=np.uint8)
    lib.synth_page_batch(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b, h, w, 0 if mode == "seg" else 1,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(_SIZES), meta.shape[0] // len(_SIZES),
        int(num_runs[0]), int(num_runs[1]), float(vertical_prob),
    )
    return img, mask[..., None]


def segmentation_sample_native(rng: np.random.Generator, size=(512, 512)):
    """f32 drop-in for text_overlay.segmentation_sample via the engine."""
    img, mask = synth_pages_u8([int(rng.integers(0, 2**63))], size, mode="seg")
    return (img[0].astype(np.float32) / 255.0, mask[0].astype(np.float32))


def inpainting_page_native(rng: np.random.Generator, size=(512, 512)):
    """(clean_page f32, text_mask f32) — callers build hole masks."""
    img, mask = synth_pages_u8([int(rng.integers(0, 2**63))], size, mode="inpaint")
    return (img[0].astype(np.float32) / 255.0, mask[0].astype(np.float32))


if __name__ == "__main__":
    bits, meta, sizes = render_atlas()
    np.savez_compressed(ATLAS_PATH, bits=bits, meta=meta, sizes=sizes)
    print(f"wrote {ATLAS_PATH}: {bits.nbytes} glyph bytes, {meta.shape[0]} glyphs")
