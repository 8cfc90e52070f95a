"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both. Tolerances: float32
results of the same algorithm agree to rtol 1e-3 / atol 1e-4 (the
oracle tolerance of tests/test_models_parity.py; the two frameworks sum
convolutions in other orders); masks, nearest upsampling and dilation
are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_segmentation_image_inpainting_tpu.ops import morphology as jmorph
from text_segmentation_image_inpainting_tpu.ops import partial_conv as jpc
from text_segmentation_image_inpainting_tpu.ops import resize as jresize
from text_segmentation_image_inpainting_tpu_torch.ops import conv as tconv
from text_segmentation_image_inpainting_tpu_torch.ops import morphology as tmorph
from text_segmentation_image_inpainting_tpu_torch.ops import partial_conv as tpc
from text_segmentation_image_inpainting_tpu_torch.ops import resize as tresize
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
from tests.test_torch_bridge import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


RTOL, ATOL = 1e-3, 1e-4


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def holes(rng, shape, p_valid=0.6, block=4):
    """Random binary mask (1 = valid) with an all-hole block in the
    corner of the first image, so some windows see no valid pixel."""
    m = (rng.random(shape) < p_valid).astype(np.float32)
    m[0, :block, :block] = 0
    return m


@pytest.mark.parametrize("out_hw", [(11, 13), (3, 4), (10, 14)])
def test_resize_bilinear(out_hw):
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw))
    got = tresize.resize_bilinear(t(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_upsample_nearest_exact():
    x = np.random.default_rng(1).standard_normal((2, 3, 5, 4)).astype(np.float32)
    for f in (1, 2, 3):
        want = np.asarray(jresize.upsample_nearest(jnp.asarray(x), f))
        np.testing.assert_array_equal(tresize.upsample_nearest(t(x), f).numpy(), want)


@pytest.mark.parametrize("radius,squeezed", [(1, False), (3, False), (3, True), (0, True)])
def test_dilate_mask_exact(radius, squeezed):
    m = (np.random.default_rng(radius).random((2, 19, 23, 1)) > 0.97).astype(np.float32)
    if squeezed:
        m = m[..., 0]  # the pipeline dilates the squeezed (N, H, W) mask
    want = np.asarray(jmorph.dilate_mask(jnp.asarray(m), radius))
    got = tmorph.dilate_mask(t(m), radius)
    assert got.shape == m.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # bf16 masks dilate to the same values
    np.testing.assert_array_equal(tmorph.dilate_mask(t(m, torch.bfloat16), radius).float(), want)


def test_binarize():
    p = np.random.default_rng(2).random((2, 6, 6, 1)).astype(np.float32)
    want = np.asarray(jmorph.binarize(jnp.asarray(p), 0.4))
    np.testing.assert_array_equal(tmorph.binarize(t(p), 0.4).numpy(), want)


def test_torch_same_padding():
    for k, d in ((3, 1), (7, 1), (3, 2), (3, 4), ((5, 3), (1, 2))):
        from text_segmentation_image_inpainting_tpu.ops.conv import torch_same_padding

        assert tconv.torch_same_padding(k, d) == torch_same_padding(k, d)


@pytest.mark.parametrize("groups,stride,dilation", [
    ((5,), 1, 1), ((4, 3), 1, 1), ((4, 3), 2, 1), ((2, 6), 1, 2),
])
def test_mask_window_sum_exact(groups, stride, dilation):
    rng = np.random.default_rng(3)
    m = holes(rng, (2, 13, 11, len(groups)))
    kw = dict(stride=(stride, stride), padding=(dilation, dilation), dilation=(dilation, dilation))
    want = np.asarray(jpc.mask_window_sum(jnp.asarray(m), groups, (3, 3), **kw))
    got = tpc.mask_window_sum(t(m), groups, (3, 3), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_and_broadcast_mask():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 5, 7)).astype(np.float32)
    m = holes(rng, (2, 5, 5, 2), block=2)
    want = np.asarray(jpc.apply_mask(jnp.asarray(x), jnp.asarray(m), (3, 4)))
    np.testing.assert_array_equal(tpc.apply_mask(t(x), t(m), (3, 4)).numpy(), want)
    want = np.asarray(jpc.broadcast_mask(jnp.asarray(m), (3, 4)))
    np.testing.assert_array_equal(tpc.broadcast_mask(t(m), (3, 4)).numpy(), want)


def _pconv_case(seed, groups, cout, k=3, hw=(12, 12)):
    rng = np.random.default_rng(seed)
    cin = sum(groups)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    m = holes(rng, (2, *hw, len(groups)))
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal((cout,))).astype(np.float32)
    return x, m, w, b


def _jax_pconv(x, m, w, b, groups, stride, pad):
    y, nm = jpc.partial_conv2d(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(w), None if b is None else jnp.asarray(b),
        group_sizes=groups, stride=stride, padding=pad,
    )
    return np.asarray(y, np.float32), np.asarray(nm, np.float32)


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cout", [3, 16])
@pytest.mark.parametrize("groups", [(6,), (4, 5)], ids=["G1", "G2"])
def test_partial_conv2d_matches_jax(groups, cout, stride, use_bias):
    """``partial_conv2d`` on CPU tensors: stride 1 takes
    ``partial_conv2d_reference`` (the kernels' plain version), stride 2
    the plain two-conv formulation. Both against JAX ``impl='xla'``."""
    x, m, w, b = _pconv_case(10 * len(groups) + cout + stride, groups, cout)
    b = b if use_bias else None
    want_y, want_m = _jax_pconv(x, m, w, b, groups, stride, 1)
    y, nm = tpc.partial_conv2d(
        t(x), t(m), t(w.transpose(3, 2, 0, 1)), None if b is None else t(b),
        group_sizes=groups, stride=stride, padding=1,
    )
    np.testing.assert_array_equal(nm.numpy(), want_m)
    assert (want_m == 0).any(), "the case must hold all-hole windows"
    empty = nm.numpy()[..., 0] == 0
    assert (y.numpy()[empty] == 0).all()
    np.testing.assert_allclose(y.numpy(), want_y, rtol=RTOL, atol=ATOL)
    if stride == 1:
        ref_y, ref_m = kpc.partial_conv2d_reference(
            t(x), t(m), t(w.transpose(3, 2, 0, 1)), None if b is None else t(b),
            group_sizes=groups, padding=(1, 1),
        )
        assert torch.equal(ref_y, y) and torch.equal(ref_m, nm)


def test_partial_conv2d_reference_bf16_head_level():
    """bf16 at the U-Net head's grouping (64 + 3 -> 3). The plain version
    keeps the f32 conv through the epilogue (as the Pallas kernel does),
    so it sits within the 0.55% bound of tests/test_ops_parity.py (bf16
    inputs and weights, one bf16 rounding of y) of the f32 JAX result,
    and no further from it than JAX's own bf16 path. Masks are exact."""
    groups = (64, 3)
    x, m, w, b = _pconv_case(7, groups, 3, hw=(16, 16))
    want_y, want_m = _jax_pconv(x, m, w, b, groups, 1, 1)
    jax_bf16, _ = jpc.partial_conv2d(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(m, jnp.bfloat16),
        jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        group_sizes=groups, padding=1,
    )
    y, nm = kpc.partial_conv2d_reference(
        t(x, torch.bfloat16), t(m, torch.bfloat16), t(w.transpose(3, 2, 0, 1)), t(b),
        group_sizes=groups, padding=(1, 1),
    )
    assert y.dtype == nm.dtype == torch.bfloat16
    np.testing.assert_array_equal(nm.float().numpy(), want_m)
    scale = np.abs(want_y).max()
    rel = np.abs(y.float().numpy() - want_y).max() / scale
    rel_jax = np.abs(np.asarray(jax_bf16, np.float32) - want_y).max() / scale
    assert rel < 0.0055, rel
    assert rel <= rel_jax * 1.5 + 1e-3, (rel, rel_jax)


def test_routing_cpu_counts_no_launch():
    """CPU tensors take the plain version and launch nothing."""
    x, m, w, b = _pconv_case(5, (4, 5), 16)
    k1, k2 = kpc.K1_LAUNCHES, kpc.K2_LAUNCHES
    for cout in (16, 3):
        tpc.partial_conv2d(t(x), t(m), t(w[..., :cout].transpose(3, 2, 0, 1)), None,
                           group_sizes=(4, 5), padding=1)
    assert (kpc.K1_LAUNCHES, kpc.K2_LAUNCHES) == (k1, k2)


@pytest.mark.parametrize("launch", ["_launch_k1", "_launch_k2"])
def test_kernel_wrappers_refuse_cpu_tensors(launch):
    """The CUDA wrappers raise on what the kernels do not take; they never
    compute a result another way."""
    x, m, w, b = _pconv_case(6, (4, 5), 16)
    k1, k2 = kpc.K1_LAUNCHES, kpc.K2_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(kpc, launch)(t(x, torch.bfloat16), t(m, torch.bfloat16),
                             t(w.transpose(3, 2, 0, 1)), None, (4, 5), (1, 1))
    assert (kpc.K1_LAUNCHES, kpc.K2_LAUNCHES) == (k1, k2)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "CUDA_HOME", build.Path("/nonexistent-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


@pytest.mark.slow
def test_reference_matches_pallas_kernels_bf16():
    """The plain version against the TPU kernels themselves (interpret mode,
    tiny shapes; minutes on a CPU host, hence the slow tier), at bf16 where
    their rounding differs from the XLA twin's: _pallas_forward (Cout 16)
    and _pallas_forward_small_cout (Cout 3). M' equal; y within one bf16
    step of |y| plus 1e-3 max |y| (f32 sums in other orders)."""
    from text_segmentation_image_inpainting_tpu.ops.pallas.partial_conv_kernel import (
        partial_conv2d_pallas,
    )

    groups = (12, 4)
    for cout in (16, 3):
        x, m, w, b = _pconv_case(20 + cout, groups, cout, hw=(8, 8))
        jy, jm = partial_conv2d_pallas(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(m, jnp.bfloat16),
            jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
            groups, (1, 1), (1, 1), (1, 1), True,
        )
        y, nm = kpc.partial_conv2d_reference(
            t(x, torch.bfloat16), t(m, torch.bfloat16), t(w.transpose(3, 2, 0, 1)), t(b),
            group_sizes=groups, padding=(1, 1),
        )
        np.testing.assert_array_equal(nm.float().numpy(), np.asarray(jm, np.float32))
        want = np.asarray(jy, np.float32)
        err = np.abs(y.float().numpy() - want)
        assert (err <= 2.0**-7 * np.abs(want) + 1e-3 * np.abs(want).max()).all(), err.max()
