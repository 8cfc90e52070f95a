"""The PyTorch port's page pipeline against the JAX package's, on the CPU.

Both pipelines get the same weights (``compat/from_jax.py``), the same
numpy pages and the same threshold, at float32: a narrow segmenter
(width 0.35) and a depth-3 U-Net in its literal composition
(``fuse_up=False``, the composition the port runs) on 64x64 pages.

The threshold is placed in the widest gap between the sorted JAX logits
from the 70th to the 90th percentile, so 10-30% of the pixels are text
before dilation and none sits on the threshold. Text
masks must then be equal bit for bit, except at pixels whose JAX logit
lies within 1e-4 of the threshold (counted; 0 at this seed). Clean
pages agree to rtol 1e-3 / atol 1e-4, the oracle tolerance of
tests/test_models_parity.py, with atol raised to 1e-6 max|y| (about 8
float32 ulps of the largest value): with random weights the U-Net's
output reaches |y| ~ 500, and summation-order differences grow with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import (
    SEG_WIDTH,
    jax_segmenter_variables,
    jax_unet_variables,
    one_torch_thread,
    port_segmenter,
    port_unet,
)
from text_segmentation_image_inpainting_tpu.data.masks import random_hole_mask
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu.pipeline import end_to_end as jpipe
from text_segmentation_image_inpainting_tpu_torch.pipeline import (
    TextRemovalPipeline,
    pad_to_multiple,
    preprocess_page,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


RTOL, ATOL = 1e-3, 1e-4
DEPTH = 3
RADIUS = 1


@pytest.fixture(scope="module")
def pair():
    seg = JaxTextSegmenter(width_mult=SEG_WIDTH)
    unet = JaxInpaintUNet(depth=DEPTH, fuse_up=False)
    seg_vars = jax_segmenter_variables(seg, seed=3)
    # random weights give logits within ~0.3 of each other; spread them
    # (on both sides) so a 1e-4 band around the threshold is meaningful
    head = seg_vars["params"]["decoder"]["head"]
    head["kernel"] = head["kernel"] * 100.0
    unet_vars = jax_unet_variables(unet, seed=4)
    pages = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    logits = np.sort(np.asarray(jax.jit(seg.apply)(seg_vars, jnp.asarray(pages))).ravel())
    lo, hi = int(0.7 * logits.size), int(0.9 * logits.size)
    i = lo + int(np.argmax(np.diff(logits[lo:hi])))  # the widest gap there
    logit_t = 0.5 * (logits[i] + logits[i + 1])
    threshold = float(1.0 / (1.0 + np.exp(-np.float64(logit_t))))
    jax_pipe = jpipe.TextRemovalPipeline(
        threshold=threshold, dilate_radius=RADIUS, seg=seg, unet=unet,
        compute_dtype=jnp.float32,
    )
    port_pipe = TextRemovalPipeline(
        port_segmenter(seg_vars, width_mult=SEG_WIDTH), port_unet(unet_vars, depth=DEPTH),
        threshold=threshold, dilate_radius=RADIUS, compute_dtype=torch.float32,
    ).eval()
    return jax_pipe, (seg_vars, unet_vars), port_pipe, pages


def assert_close(got, want):
    atol = max(ATOL, 1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _near_threshold(jax_pipe, seg_vars, pages):
    """Pixels whose JAX logit lies within 1e-4 of the threshold logit."""
    padded, (h, w) = jpipe.pad_to_multiple(jnp.asarray(pages), 1 << DEPTH)
    logits = np.asarray(jax_pipe.seg.apply(seg_vars, padded))[:, :h, :w]
    t = jax_pipe.threshold
    return np.abs(logits - np.log(t / (1.0 - t))) < 1e-4


def _assert_masks_equal(got, want, near):
    diff = got != want
    assert near.sum() == 0, f"{near.sum()} logits within 1e-4 of the threshold"
    assert not (diff & ~near).any(), f"{int(diff.sum())} mask pixels differ"


def test_run_matches_jax(pair):
    jax_pipe, (seg_vars, unet_vars), port_pipe, pages = pair
    j_clean, j_mask = jax.jit(jax_pipe.run)(seg_vars, unet_vars, jnp.asarray(pages))
    clean, mask = port_pipe.run(torch.from_numpy(pages))
    assert clean.shape == pages.shape and mask.shape == pages.shape[:3] + (1,)
    assert clean.dtype == mask.dtype == torch.float32
    _assert_masks_equal(mask.numpy(), np.asarray(j_mask), _near_threshold(jax_pipe, seg_vars, pages))
    frac = mask.numpy().mean()
    assert 0.05 < frac < 0.95, f"degenerate text mask ({frac:.1%} text)"
    assert_close(clean.numpy(), np.asarray(j_clean))
    keep = np.broadcast_to(mask.numpy() == 0, pages.shape)
    np.testing.assert_array_equal(clean.numpy()[keep], pages[keep])  # non-text untouched


@pytest.mark.parametrize("dilate", [True, False], ids=["dilated", "raw"])
def test_segment_matches_jax(pair, dilate):
    jax_pipe, (seg_vars, _), port_pipe, pages = pair
    want = np.asarray(jax_pipe.segment(seg_vars, jnp.asarray(pages), dilate=dilate))
    got = port_pipe.segment(torch.from_numpy(pages), dilate=dilate).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    _assert_masks_equal(got, want, _near_threshold(jax_pipe, seg_vars, pages))


def test_inpaint_given_mask_matches_jax(pair):
    jax_pipe, (_, unet_vars), port_pipe, pages = pair
    rng = np.random.default_rng(7)
    text = np.stack([1.0 - random_hole_mask(rng, (64, 64)) for _ in range(2)])
    assert 0 < text.mean() < 1
    want = np.asarray(jax_pipe.inpaint(unet_vars, jnp.asarray(pages), jnp.asarray(text)))
    got = port_pipe.inpaint(torch.from_numpy(pages), torch.from_numpy(text)).numpy()
    assert_close(got, want)
    keep = np.broadcast_to(text == 0, pages.shape)
    np.testing.assert_array_equal(got[keep], pages[keep])


def test_odd_page_size_pads_and_crops_like_jax(pair):
    """37x45 pages: edge-padded to the U-Net multiple and cropped back;
    ``inpaint`` forces the pad strip valid, ``run`` does not."""
    jax_pipe, (seg_vars, unet_vars), port_pipe, _ = pair
    rng = np.random.default_rng(8)
    pages = rng.uniform(0, 1, (1, 37, 45, 3)).astype(np.float32)
    j_clean, j_mask = jax_pipe.run(seg_vars, unet_vars, jnp.asarray(pages))
    clean, mask = port_pipe.run(torch.from_numpy(pages))
    assert clean.shape == pages.shape and mask.shape == (1, 37, 45, 1)
    _assert_masks_equal(mask.numpy(), np.asarray(j_mask), _near_threshold(jax_pipe, seg_vars, pages))
    assert_close(clean.numpy(), np.asarray(j_clean))
    text = (rng.random((1, 37, 45, 1)) < 0.2).astype(np.float32)
    text[:, -2:, :] = 1  # text on the bottom edge: the edge pad would copy it
    want = np.asarray(jax_pipe.inpaint(unet_vars, jnp.asarray(pages), jnp.asarray(text)))
    got = port_pipe.inpaint(torch.from_numpy(pages), torch.from_numpy(text)).numpy()
    assert got.shape == pages.shape
    assert_close(got, want)


def test_pad_to_multiple_matches_jax():
    x = np.random.default_rng(9).random((2, 5, 7, 3)).astype(np.float32)
    want, want_hw = jpipe.pad_to_multiple(jnp.asarray(x), 4)
    got, hw = pad_to_multiple(torch.from_numpy(x), 4)
    assert hw == want_hw == (5, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same, hw = pad_to_multiple(torch.from_numpy(x[:, :4, :4]), 4)
    assert hw == (4, 4) and same.shape == (2, 4, 4, 3)


def test_preprocess_page_matches_jax():
    img = np.random.default_rng(10).integers(0, 256, (2, 30, 50, 3), dtype=np.uint8)
    want = np.asarray(jpipe.preprocess_page(jnp.asarray(img), (64, 64)))
    got = preprocess_page(torch.from_numpy(img), (64, 64))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_default_pipeline_is_bf16_full_size():
    """The defaults the product runs: bf16 models, depth 8, threshold 0.5,
    dilation radius 3 (built only, not run, on the CPU)."""
    pipe = TextRemovalPipeline()
    assert pipe.compute_dtype == torch.bfloat16
    assert pipe.seg.decoder.dtype == torch.bfloat16 and pipe.unet.dtype == torch.bfloat16
    assert pipe.unet.depth == 8 and pipe.threshold == 0.5 and pipe.dilate_radius == 3
