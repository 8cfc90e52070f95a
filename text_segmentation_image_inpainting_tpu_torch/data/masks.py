"""Irregular hole-mask generation for inpainting training.

The port's own copy of ``text_segmentation_image_inpainting_tpu/data/masks.py``.

The reference draws random free-form strokes (cv2 lines/circles) to make
hole masks. Host-side generation here is pure numpy (no cv2 dependency
needed): random walks rasterized with thick round brushes, plus
rectangle holes. Convention matches the framework: mask value 1 = valid
pixel, 0 = hole.
"""

from __future__ import annotations

import numpy as np


def _stamp_disk(canvas: np.ndarray, cy: float, cx: float, radius: int) -> None:
    h, w = canvas.shape
    r = int(radius)
    y0, y1 = max(0, int(cy) - r), min(h, int(cy) + r + 1)
    x0, x1 = max(0, int(cx) - r), min(w, int(cx) + r + 1)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    canvas[y0:y1, x0:x1] |= ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r


def random_stroke_mask(
    rng: np.random.Generator,
    size: tuple[int, int] = (512, 512),
    *,
    num_strokes: tuple[int, int] = (2, 6),
    stroke_steps: tuple[int, int] = (8, 24),
    radius: tuple[int, int] = (6, 24),
    step_len: tuple[int, int] = (8, 32),
) -> np.ndarray:
    """Free-form stroke holes. Returns (H, W, 1) float32, 1 = valid."""
    h, w = size
    holes = np.zeros((h, w), dtype=bool)
    for _ in range(int(rng.integers(*num_strokes))):
        y, x = rng.uniform(0, h), rng.uniform(0, w)
        angle = rng.uniform(0, 2 * np.pi)
        r = int(rng.integers(*radius))
        for _ in range(int(rng.integers(*stroke_steps))):
            _stamp_disk(holes, y, x, r)
            angle += rng.uniform(-0.8, 0.8)
            ln = rng.uniform(*step_len)
            y = np.clip(y + ln * np.sin(angle), 0, h - 1)
            x = np.clip(x + ln * np.cos(angle), 0, w - 1)
    return (~holes).astype(np.float32)[..., None]


def random_rect_mask(
    rng: np.random.Generator,
    size: tuple[int, int] = (512, 512),
    *,
    num_rects: tuple[int, int] = (1, 4),
    rect_frac: tuple[float, float] = (0.05, 0.25),
) -> np.ndarray:
    """Axis-aligned rectangular holes (text-balloon-ish). (H,W,1), 1=valid."""
    h, w = size
    holes = np.zeros((h, w), dtype=bool)
    for _ in range(int(rng.integers(*num_rects))):
        rh = int(rng.uniform(*rect_frac) * h)
        rw = int(rng.uniform(*rect_frac) * w)
        y = int(rng.integers(0, max(1, h - rh)))
        x = int(rng.integers(0, max(1, w - rw)))
        holes[y : y + rh, x : x + rw] = True
    return (~holes).astype(np.float32)[..., None]


def random_hole_mask(rng: np.random.Generator, size=(512, 512)) -> np.ndarray:
    """Mix of strokes and rectangles, the training-time default."""
    mask = random_stroke_mask(rng, size)
    if rng.random() < 0.5:
        mask = mask * random_rect_mask(rng, size)
    return mask
