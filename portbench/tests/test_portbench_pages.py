"""The frozen traffic engines draw the port's bytes from the same seeds."""

import numpy as np
import pytest

from portbench import pages

SEEDS = [0, 1, 2**40 + 7, 2**63 + 5, 123456789012345]


@pytest.mark.parametrize("mode", ["seg", "inpaint"])
def test_pages_are_the_ports_bytes(mode):
    native_pages = pytest.importorskip(
        "text_segmentation_image_inpainting_tpu_torch.data.native_pages")
    if not native_pages.available():
        pytest.skip("the port's page engine did not build")
    ours = pages.synth_pages_u8(SEEDS, (96, 128), mode=mode)
    theirs = native_pages.synth_pages_u8(SEEDS, (96, 128), mode=mode)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_hole_masks_are_the_ports():
    native_masks = pytest.importorskip(
        "text_segmentation_image_inpainting_tpu_torch.data.native_masks")
    if not native_masks.available():
        pytest.skip("the port's mask engine did not build")
    a = pages.hole_masks(SEEDS, (64, 80))
    b = native_masks.random_hole_masks(SEEDS, (64, 80))
    assert np.array_equal(a, b)
    assert 0.0 < float(a.mean()) < 1.0


def test_engine_seeds_depend_on_seed_and_stream_only():
    a = pages.engine_seeds(2**33 + 1, "serve.pages", 8)
    assert a.dtype == np.uint64 and len(set(a.tolist())) == 8
    assert np.array_equal(a, pages.engine_seeds(2**33 + 1, "serve.pages", 8))
    assert np.array_equal(a[:3], pages.engine_seeds(2**33 + 1, "serve.pages", 3))
    assert not np.array_equal(a, pages.engine_seeds(2**33 + 2, "serve.pages", 8))
    assert not np.array_equal(a, pages.engine_seeds(2**33 + 1, "seg.pages", 8))


def test_text_masks_mark_the_composited_text():
    img, text = pages.synth_pages_u8(pages.engine_seeds(5, "t", 2), (128, 128), mode="seg")
    clean, text2 = pages.synth_pages_u8(pages.engine_seeds(5, "t", 2), (128, 128),
                                        mode="inpaint")
    assert np.array_equal(text, text2) and set(np.unique(text)) <= {0, 1}
    differs = (img != clean).any(axis=-1)
    assert not differs[text[..., 0] == 0].any()  # the text changes only text pixels
