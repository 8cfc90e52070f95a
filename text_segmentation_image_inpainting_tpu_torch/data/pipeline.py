"""Page batches for segmentation and inpainting training.

Counterpart of ``text_segmentation_image_inpainting_tpu/data/pipeline.py``
(``PageSource``, ``list_image_paths``, ``make_dataset``).
Sample ``idx`` is drawn from ``np.random.default_rng((seed << 32) ^ idx)``
as in JAX, by the port's own copy of the JAX package's generators
(``data/text_overlay.py``, ``data/native_masks.py``, ``data/masks.py``,
``data/native_pages.py`` and their C++ sources under ``data/native/``:
numpy, PIL and ctypes), imported where they are used, so the two
packages draw the same pages from the same seeds. Batches are taken in
index order and stacked by hand: there is no grain shuffle and no
device prefetcher yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Sequence

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
