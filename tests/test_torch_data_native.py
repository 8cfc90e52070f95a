"""The port's native page and mask engines built at first use, by several
processes at once, as test workers do in a fresh checkout.

``data/native/Makefile`` links each library under a name of its own and
renames it into place, so no process can load a half-written library
(which ``ctypes`` refuses, and the generators then silently fall back to
the PIL and numpy paths, which draw other pages). Six processes start
together on a copy of the port's ``data/`` package with no library built;
each must find both engines and draw the same bits.
"""

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = "text_segmentation_image_inpainting_tpu_torch"

DRAW = f"""
import numpy as np
from {PKG}.data import native_masks, native_pages
assert native_pages.available() and native_masks.available()
img, mask = native_pages.synth_pages_u8([1, 2], (64, 64))
holes = native_masks.random_hole_masks([3], (64, 64))
print(int(img.sum()), int(mask.sum()), float(holes.sum()))
"""


def test_concurrent_first_builds_all_load(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    shutil.copy(REPO / PKG / "__init__.py", pkg)
    shutil.copytree(REPO / PKG / "data", pkg / "data",
                    ignore=shutil.ignore_patterns("*.so", "*.tmp", "__pycache__"))
    procs = [subprocess.Popen([sys.executable, "-c", DRAW], cwd=tmp_path, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-500:] for _, err in outs]
    assert len({out for out, _ in outs}) == 1, outs
    assert sorted(f.name for f in (pkg / "data" / "native").iterdir() if f.suffix != ".cpp") == [
        "Makefile", "libmaskgen.so", "libpagegen.so"]
