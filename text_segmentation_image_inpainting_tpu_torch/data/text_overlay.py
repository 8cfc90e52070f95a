"""Synthetic text overlay for segmentation training pairs.

The port's own copy of
``text_segmentation_image_inpainting_tpu/data/text_overlay.py``: the same
code (numpy, PIL and ctypes), so the two packages draw the same pages
from the same seeds.

The reference trains on clean manga/anime images with synthetically
overlaid text -> (image-with-text, binary text-mask) pairs. This module
renders random glyph runs with PIL onto any base image and returns the
exact binary mask of rendered pixels. With no dataset on disk,
``synthetic_page`` procedurally generates
manga-like base pages (panels, tones, line art) so the full training
path is exercisable end-to-end. PIL is imported where it draws: the
samplers' native path (``data/native_pages.py``) needs none, so pages are
drawn on a machine without PIL too.
"""

from __future__ import annotations

import string

import numpy as np

_CHARS = string.ascii_letters + string.digits + "!?.,;:「」…ー一二三人大小中出日月火水木金土"


def _font(size: int):
    from PIL import ImageFont

    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # older PIL: fixed-size bitmap font
        return ImageFont.load_default()


def synthetic_page(rng: np.random.Generator, size: tuple[int, int] = (512, 512)) -> np.ndarray:
    """Procedural manga-ish page: white bg, panel borders, gray tones,
    random line art. Returns (H, W, 3) float32 in [0, 1]."""
    from PIL import Image, ImageDraw

    h, w = size
    img = Image.new("L", (w, h), color=255)
    draw = ImageDraw.Draw(img)
    # panels
    for _ in range(int(rng.integers(1, 4))):
        x0, y0 = rng.integers(0, w // 2), rng.integers(0, h // 2)
        x1 = rng.integers(x0 + w // 4, w)
        y1 = rng.integers(y0 + h // 4, h)
        fill = int(rng.integers(140, 255))
        draw.rectangle([int(x0), int(y0), int(x1), int(y1)], fill=fill, outline=0, width=3)
    # line art: random polylines and ellipses
    for _ in range(int(rng.integers(5, 20))):
        pts = rng.integers(0, [w, h], size=(int(rng.integers(2, 5)), 2))
        draw.line([tuple(p) for p in pts.tolist()], fill=int(rng.integers(0, 100)),
                  width=int(rng.integers(1, 4)))
    for _ in range(int(rng.integers(2, 8))):
        x0, y0 = rng.integers(0, w - 40), rng.integers(0, h - 40)
        x1, y1 = x0 + rng.integers(20, w - x0), y0 + rng.integers(20, h - y0)
        draw.ellipse([int(x0), int(y0), int(x1), int(y1)],
                     outline=int(rng.integers(0, 120)), width=2)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return np.repeat(arr[..., None], 3, axis=-1)


def overlay_text(
    image: np.ndarray,
    rng: np.random.Generator,
    *,
    num_runs: tuple[int, int] = (3, 10),
    font_size: tuple[int, int] = (12, 48),
    vertical_prob: float = 0.4,
) -> tuple[np.ndarray, np.ndarray]:
    """Render random text runs onto ``image`` ((H,W,3) float in [0,1]).

    Returns (image_with_text, text_mask) where text_mask is (H,W,1)
    float32 with 1 exactly on rendered glyph pixels.
    """
    from PIL import Image, ImageDraw

    h, w = image.shape[:2]
    text_layer = Image.new("L", (w, h), color=0)
    draw = ImageDraw.Draw(text_layer)
    for _ in range(int(rng.integers(*num_runs))):
        size = int(rng.integers(*font_size))
        font = _font(size)
        n_chars = int(rng.integers(1, 12))
        run = "".join(rng.choice(list(_CHARS), size=n_chars))
        x, y = int(rng.integers(0, max(1, w - size))), int(rng.integers(0, max(1, h - size)))
        if rng.random() < vertical_prob:
            for ch in run:  # vertical manga-style column
                draw.text((x, y), ch, fill=255, font=font)
                y += size
                if y > h - size:
                    break
        else:
            draw.text((x, y), run, fill=255, font=font)
    mask = (np.asarray(text_layer, dtype=np.float32) > 127.0).astype(np.float32)
    # random text color: black / white / dark gray
    color = float(rng.choice([0.0, 0.08, 0.15, 1.0], p=[0.55, 0.15, 0.1, 0.2]))
    out = image * (1.0 - mask[..., None]) + color * mask[..., None]
    return out.astype(np.float32), mask[..., None]


def segmentation_sample(rng: np.random.Generator, size=(512, 512), *, native: bool | None = None):
    """One (image_with_text, text_mask) training pair, fully synthetic.

    ``native=None`` auto-selects the C++ page engine
    (``data/native_pages.py``, about 11x faster than the PIL path);
    ``False`` forces the PIL reference implementation.
    """
    if native is not False:
        from text_segmentation_image_inpainting_tpu_torch.data import native_pages

        if native_pages.available():
            return native_pages.segmentation_sample_native(rng, size)
        if native:
            raise RuntimeError("native page engine requested but unavailable")
    page = synthetic_page(rng, size)
    return overlay_text(page, rng)


def inpainting_sample(rng: np.random.Generator, size=(512, 512), *, native: bool | None = None):
    """One (gt_image, hole_mask) pair: gt is a clean synthetic page, the
    hole mask mixes text-shaped holes (the product case) and random
    strokes. mask: 1 = valid. ``native`` as in ``segmentation_sample``."""
    from text_segmentation_image_inpainting_tpu_torch.data.masks import random_hole_mask

    if native is not False:
        from text_segmentation_image_inpainting_tpu_torch.data import native_masks, native_pages

        if native_pages.available():
            page, text_mask = native_pages.inpainting_page_native(rng, size)
            if rng.random() < 0.5:
                return page, (1.0 - text_mask).astype(np.float32)
            mask = native_masks.random_hole_masks(
                [int(rng.integers(0, 2**63))], size
            )[0]
            return page, mask.astype(np.float32)
        if native:
            raise RuntimeError("native page engine requested but unavailable")
    page = synthetic_page(rng, size)
    if rng.random() < 0.5:
        _, text_mask = overlay_text(page, rng)
        # text-shaped holes, dilated a little like the product pipeline
        mask = 1.0 - text_mask
    else:
        mask = random_hole_mask(rng, size)
    return page, mask.astype(np.float32)
