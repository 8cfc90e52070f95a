"""The whole page pipeline over H bands (``parallel/spatial.py::spatial_pipeline_run``)
and the band-aware leaf ops (``ops/bands.py``), on the CPU.

Bands run on meshes that repeat the CPU. The leaf ops under
``spatial_axis`` are held bit for bit to the same op on the whole page,
at 2 and 4 bands, in f32 and bf16. The pipeline is held bit for bit to
the port's own unbanded ``run``, and to JAX's ``jax.jit(pipe.run)`` in
JAX's configuration of ``tests/test_spatial_parallel.py`` (weights carried
over by ``compat/from_jax.py``): the masks bit for bit, the clean pages
within 1e-5 (the two frameworks' convolutions sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import (
    jax_segmenter_variables,
    one_torch_thread,
    port_segmenter,
    port_unet,
    randomize_variables,
)
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu.pipeline import end_to_end as jpipe
from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, TextSegmenter
from text_segmentation_image_inpainting_tpu_torch.ops.bands import mean_hw, spatial_axis
from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d, torch_same_padding
from text_segmentation_image_inpainting_tpu_torch.ops.morphology import dilate_mask
from text_segmentation_image_inpainting_tpu_torch.ops.resize import resize_bilinear
from text_segmentation_image_inpainting_tpu_torch.parallel import make_mesh, spatial_pipeline_run
from text_segmentation_image_inpainting_tpu_torch.parallel.spatial import run_bands
from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline

DTYPES = [torch.float32, torch.bfloat16]
BANDS = [2, 4]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def banded(n: int, fn, *inputs):
    """``fn(*bands)`` under ``spatial_axis`` on each of ``n`` H bands of the
    inputs, gathered."""
    def local(ring, *bands):
        with spatial_axis(ring):
            return fn(*bands)

    return run_bands(make_mesh(n, platform="cpu"), local, inputs)


def _t(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


# --- the leaf ops, bit for bit ------------------------------------------------

# (kernel, dilation, depthwise, stride): the segmenter's geometries (the
# MobileNetV2 stem and strided depthwise, its dilated depthwise at output
# stride 8, the ASPP's dilated 3x3, the 1x1s) and Xception's 1x1 stride-2 skip
CONVS = [(1, 1, False, 1), (3, 1, False, 1), (3, 2, False, 1), (3, 4, False, 1),
         (3, 1, True, 1), (3, 2, True, 1), (3, 4, True, 1), (3, 1, False, 2),
         (3, 1, True, 2), (1, 1, False, 2)]


@pytest.mark.parametrize("k,d,depthwise,s", CONVS,
                         ids=[f"k{k}d{d}{'dw' if dw else ''}s{s}" for k, d, dw, s in CONVS])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", BANDS)
def test_conv2d_over_bands_is_bit_equal(n, dtype, k, d, depthwise, s):
    """Tolerance: none. A band takes p rows above and max(p - (s - 1), 0)
    below (a 1x1 stride-2 conv takes none and crops nothing)."""
    rng = np.random.default_rng(k * 100 + d * 10 + s)
    c = 8
    x = _t(rng, (2, 32, 12, c), dtype)
    w = _t(rng, (c, 1 if depthwise else c, k, k), torch.float32) * 0.3
    b = _t(rng, (c,), torch.float32)
    kw = dict(stride=s, padding=torch_same_padding(k, d), dilation=d, groups=c if depthwise else 1)
    want = conv2d(x, w, b, **kw)
    got = banded(n, lambda xb: conv2d(xb, w, b, **kw), x)
    assert got.shape == want.shape == (2, 32 // s, 12 // s, c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("f", [2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", BANDS)
def test_resize_over_bands_is_bit_equal(n, dtype, f):
    """Tolerance: none. One source row from each real neighbour, none at
    the page's ends, f output rows cropped per halo row."""
    x = _t(np.random.default_rng(f), (2, 8, 6, 5), dtype)
    want = resize_bilinear(x, (8 * f, 6 * f))
    got = banded(n, lambda xb: resize_bilinear(xb, (xb.shape[1] * f, 6 * f)), x)
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_resize_with_zero_rows_at_the_ends_differs():
    """Why the resize asks for ``ends="none"``: the same band resize with
    the zero rows a conv takes at the page's ends (``ends="zeros"``, one
    halo row cropped on each side) blends them into the page's first and
    last output rows, where the whole-page resize clamps to the edge row.
    Every other row is bit-equal."""
    f = 2
    x = _t(np.random.default_rng(5), (1, 8, 6, 3), torch.float32) + 3.0
    want = resize_bilinear(x, (8 * f, 6 * f))

    def zero_ends(ring, xb):
        ext = ring.exchange_rows(xb, 1, 1, ends="zeros")
        out = torch.nn.functional.interpolate(ext.permute(0, 3, 1, 2),
                                              size=(ext.shape[1] * f, 6 * f), mode="bilinear",
                                              align_corners=False)
        return out.permute(0, 2, 3, 1)[:, f:-f].contiguous()

    got = run_bands(make_mesh(2, platform="cpu"), zero_ends, (x,))
    differ = (got != want).any(dim=(0, 2, 3))
    assert differ[0] and differ[-1] and not differ[1:-1].any()


def test_resize_over_bands_refuses_what_it_cannot_split():
    x = torch.zeros((1, 8, 4, 1))
    with pytest.raises(ValueError, match="integer H factor"):
        banded(2, lambda xb: resize_bilinear(xb, (6, 8)), x)
    with pytest.raises(ValueError, match="align_corners=False"):
        banded(2, lambda xb: resize_bilinear(xb, (8, 8), align_corners=True), x)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", BANDS)
def test_dilate_mask_over_bands_is_bit_equal(n, dtype):
    """Tolerance: none. The squeezed (N, H, W) text mask at radius 3, with
    text on the bands' edges and the page's."""
    m = (np.random.default_rng(n).random((2, 32, 20)) > 0.93).astype(np.float32)
    m[:, [0, 7, 8, 15, 16, 31], 3] = 1.0
    m = torch.from_numpy(m).to(dtype)
    want = dilate_mask(m, 3)
    got = banded(n, lambda mb: dilate_mask(mb, 3), m)
    assert torch.equal(got, want)


def test_a_halo_longer_than_a_band_reaches_the_bands_beyond():
    """A dilation-4 conv on bands of 2 rows: the halo spans two bands on
    each side, zeros past the page. Tolerance: none."""
    rng = np.random.default_rng(9)
    x = _t(rng, (1, 8, 5, 4), torch.float32)
    w = _t(rng, (4, 4, 3, 3), torch.float32)
    want = conv2d(x, w, padding=4, dilation=4)
    assert torch.equal(banded(4, lambda xb: conv2d(xb, w, padding=4, dilation=4), x), want)


def test_mean_over_bands_sums_the_bands_in_order():
    """DeepLab's image pooling under the bands: the page's mean, the same
    bits in every band, within f32 rounding of the unbanded mean."""
    x = _t(np.random.default_rng(3), (2, 16, 6, 5), torch.float32)
    got = banded(4, lambda xb: mean_hw(xb).expand(-1, xb.shape[1], -1, -1), x)
    assert got.shape == (2, 16, 1, 5)
    assert (got == got[:, :1]).all()
    torch.testing.assert_close(got[:, :1], x.mean(dim=(1, 2), keepdim=True), rtol=1e-6, atol=1e-6)


# --- the pipeline -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_case():
    """JAX's configuration of ``test_spatial_parallel.py``: the pipeline,
    its variables from key 0 at 64^2, and JAX's jitted ``run`` (compiled
    once per page shape)."""
    jax_pipe = jpipe.TextRemovalPipeline(seg=JaxTextSegmenter(width_mult=0.35),
                                         unet=JaxInpaintUNet(depth=5), compute_dtype=jnp.float32)
    seg_vars, unet_vars = jax_pipe.init_variables(jax.random.key(0), page_hw=(64, 64))
    return jax_pipe, seg_vars, unet_vars, jax.jit(jax_pipe.run)


def _port(seg_vars, unet_vars):
    return TextRemovalPipeline(port_segmenter(seg_vars, width_mult=0.35),
                               port_unet(unet_vars, depth=5), compute_dtype=torch.float32).eval()


def _against_run(port, pages, n):
    """The banded pipeline against the port's unbanded ``run``: bit-equal,
    in ``run``'s dtypes and shapes."""
    clean, mask = spatial_pipeline_run(make_mesh(n, platform="cpu"), port, torch.from_numpy(pages))
    want_clean, want_mask = port.run(torch.from_numpy(pages))
    assert clean.dtype == want_clean.dtype and clean.shape == want_clean.shape == pages.shape
    assert mask.shape == want_mask.shape == (*pages.shape[:3], 1)
    assert torch.equal(clean, want_clean) and torch.equal(mask, want_mask)
    return clean, mask


CASES = [((2, 64, 64, 3), 2), ((2, 128, 64, 3), 4)]
CASE_IDS = ["64x64-2bands", "128x64-4bands"]


@pytest.mark.parametrize("shape,n", CASES, ids=CASE_IDS)
def test_spatial_pipeline_run_matches_run_and_jax(jax_case, shape, n):
    """JAX's test cuts 64^2 pages into 8 bands of 8 rows; here the port's
    bands must hold a whole number of the depth-5 U-Net's 32-row blocks, so
    2 bands of 32 rows (and 128-row pages in 4). Against the port's
    unbanded ``run``: bit-equal. Against ``jax.jit(pipe.run)``: the masks
    bit-equal, the clean pages within 1e-5. (JAX's initial segmenter marks
    every pixel as text: the whole page is inpainted.)"""
    _, seg_vars, unet_vars, run = jax_case
    pages = np.random.default_rng(0).random(shape).astype(np.float32)
    clean, mask = _against_run(_port(seg_vars, unet_vars), pages, n)
    jax_clean, jax_mask = run(seg_vars, unet_vars, jnp.asarray(pages))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_mask))
    np.testing.assert_allclose(clean.numpy(), np.asarray(jax_clean), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,n", CASES, ids=CASE_IDS)
def test_spatial_pipeline_run_with_some_text(jax_case, shape, n):
    """The same with random BatchNorm statistics and biases in the
    segmenter, so that part of each page is text: bit-equal to the port's
    ``run``; against JAX the masks equal wherever no logit within 1e-4 of
    the threshold lies within the dilation radius (the frameworks' sums
    round differently there; none did when this was written), the clean
    pages within 1e-3 elsewhere: with holes in the mask, the partial convs'
    renormalisation (up to k^2 Cin / sum(M) at a hole's border) scales the
    two frameworks' f32 rounding differences up to some 5e-4 (the
    server's test against JAX allows one uint8 step, 4e-3, for the same)."""
    jax_pipe, seg_vars, unet_vars, run = jax_case
    seg_vars = randomize_variables(seg_vars, 7)
    # the head's logits spread out (x 100) and moved down, so that some 10%
    # of the pixels are text before the dilation and few lie near 0
    head = seg_vars["params"]["decoder"]["head"]
    head["kernel"], head["bias"] = head["kernel"] * 100.0, (head["bias"] - 0.09) * 100.0
    pages = np.random.default_rng(1).random(shape).astype(np.float32)
    clean, mask = _against_run(_port(seg_vars, unet_vars), pages, n)
    assert 0.02 < float(mask.mean()) < 0.98
    jax_clean, jax_mask = run(seg_vars, unet_vars, jnp.asarray(pages))
    logits = np.asarray(jax_pipe.seg.apply(seg_vars, jnp.asarray(pages)))[..., 0]
    near = dilate_mask(torch.from_numpy((np.abs(logits) < 1e-4).astype(np.float32)), 3).numpy() > 0
    differ = mask.numpy()[..., 0] != np.asarray(jax_mask)[..., 0]
    assert not (differ & ~near).any()
    keep = np.broadcast_to(~near[..., None], shape)
    np.testing.assert_allclose(clean.numpy()[keep], np.asarray(jax_clean)[keep], rtol=1e-3,
                               atol=1e-3)


def _small_pipe(**unet_kw):
    return TextRemovalPipeline(TextSegmenter(width_mult=0.35), InpaintUNet(depth=3, **unet_kw),
                               compute_dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(0))


def test_spatial_pipeline_run_pads_crops_and_restores_modes():
    """A page edge-padded to the U-Net's multiple as ``run`` pads it, then
    cropped back; the modules' modes restored (a training pipeline runs
    in eval mode and comes back training)."""
    pipe = _small_pipe().train()
    pipe.seg.decoder.eval()
    before = {name: m.training for name, m in pipe.named_modules()}
    pages = torch.from_numpy(np.random.default_rng(2).random((1, 30, 21, 3)).astype(np.float32))
    clean, mask = spatial_pipeline_run(make_mesh(2, platform="cpu"), pipe, pages)
    assert {name: m.training for name, m in pipe.named_modules()} == before
    pipe.eval()
    want_clean, want_mask = pipe.run(pages)
    assert clean.shape == want_clean.shape == (1, 30, 21, 3)
    assert torch.equal(clean, want_clean) and torch.equal(mask, want_mask)


def test_spatial_pipeline_run_refuses_what_is_not_band_local():
    pipe = _small_pipe()
    pages = torch.zeros((1, 16, 16, 3))
    with pytest.raises(ValueError, match="divisible by 4 bands"):
        spatial_pipeline_run(make_mesh(4, platform="cpu"), pipe, pages)
    attn = _small_pipe(attention=True).train()
    with pytest.raises(ValueError, match="self-attention"):
        spatial_pipeline_run(make_mesh(2, platform="cpu"), attn, torch.zeros((1, 32, 16, 3)))
    assert all(m.training for m in attn.modules())


def test_xception_deeplab_pipeline_over_two_bands():
    """The Xception backbone with the DeepLab head, its ASPP rates (12, 24,
    36) longer than a band's 4 rows at output stride 8, and its image
    pooling summed over the bands: the masks equal ``run``'s, the clean
    pages and the logits within 1e-5 (the pool's sums run in another
    order)."""
    kw = dict(backbone="xception", head="deeplab", width_mult=0.25, middle_repeats=1)
    seg = port_segmenter(jax_segmenter_variables(JaxTextSegmenter(**kw), hw=(64, 64), seed=3), **kw)
    unet = InpaintUNet(depth=5).init_weights(torch.Generator().manual_seed(1))
    pipe = TextRemovalPipeline(seg, unet, compute_dtype=torch.float32).eval()
    pages = torch.from_numpy(np.random.default_rng(4).random((2, 64, 64, 3)).astype(np.float32))
    clean, mask = spatial_pipeline_run(make_mesh(2, platform="cpu"), pipe, pages)
    want_clean, want_mask = pipe.run(pages)
    assert torch.equal(mask, want_mask) and 0 < float(mask.mean()) < 1
    torch.testing.assert_close(clean, want_clean, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        logits = banded(2, seg, pages)
        torch.testing.assert_close(logits, seg(pages), rtol=1e-5, atol=1e-5)
