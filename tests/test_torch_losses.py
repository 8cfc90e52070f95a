"""The port's inpainting loss and quality metrics against the JAX
package's, on the CPU.

Same VGG weights (bridged), same numpy inputs, float32: every loss term
and the gradient of the total agree to rtol 1e-4 (sums in another
order). JAX runs its stock VGG path, the port its fused stem (whose CPU
versions are the plain ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vgg import _jax_vgg, _port_vgg
from text_segmentation_image_inpainting_tpu.losses import inpainting as jloss
from text_segmentation_image_inpainting_tpu.train import metrics as jmetrics
from text_segmentation_image_inpainting_tpu_torch.losses import inpainting as tloss
from text_segmentation_image_inpainting_tpu_torch.train import metrics as tmetrics

RTOL, ATOL = 1e-4, 1e-6


def _images(seed, n=2, hw=(32, 32)):
    rng = np.random.default_rng(seed)
    out = rng.uniform(0, 1, (n, *hw, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (n, *hw, 3)).astype(np.float32)
    mask = (rng.random((n, *hw, 1)) > 0.3).astype(np.float32)
    mask[0, 4:14, 6:20] = 0  # a hole larger than the TV dilation
    return out, gt, mask


@pytest.fixture(scope="module")
def case():
    model, variables = _jax_vgg(hw=(32, 32), seed=2)
    return model, variables, _port_vgg(variables), _images(3)


def test_every_loss_term_and_the_gradient_match_jax(case):
    model, variables, port, (out, gt, mask) = case

    def f(o):
        return jloss.inpainting_loss(o, jnp.asarray(gt), jnp.asarray(mask), variables,
                                     config=jloss.InpaintLossConfig(), vgg_model=model)

    (_, want), vjp = jax.vjp(f, jnp.asarray(out))
    (want_grad,) = vjp((jnp.ones(()), jax.tree.map(jnp.zeros_like, want)))
    ot = torch.from_numpy(out).requires_grad_(True)
    total, got = tloss.inpainting_loss(ot, torch.from_numpy(gt), torch.from_numpy(mask), port,
                                       config=tloss.InpaintLossConfig(fused_stem=True))
    total.backward()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(ot.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=1e-7)


def test_vgg_config_follows_jax():
    cfg = tloss.InpaintLossConfig(vgg_dtype="bfloat16", vgg_taps=2, vgg_normalize=False)
    vgg = tloss.make_vgg(cfg)
    assert vgg.dtype == torch.bfloat16 and vgg.num_taps == 2 and not vgg.normalize
    assert dict(vars(tloss.InpaintLossConfig())) == dict(vars(jloss.InpaintLossConfig()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_matrix_accumulates_and_returns_f32(dtype):
    f = np.random.default_rng(4).standard_normal((2, 6, 5, 16)).astype(np.float32)
    want = np.asarray(jloss.gram_matrix(jnp.asarray(f, dtype)))
    got = tloss.gram_matrix(torch.from_numpy(f).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_total_variation_matches_jax():
    out, _, mask = _images(5)
    region = np.asarray(1.0 - mask)
    want = float(jloss.total_variation_loss(jnp.asarray(out), jnp.asarray(region)))
    got = tloss.total_variation_loss(torch.from_numpy(out), torch.from_numpy(region)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_psnr_ssim_iou_match_jax():
    out, gt, mask = _images(6)
    gt = 0.8 * out + 0.2 * gt  # a near reconstruction: SSIM's cancellation matters
    o, g = torch.from_numpy(out), torch.from_numpy(gt)
    np.testing.assert_allclose(tmetrics.psnr(o, g).item(),
                               float(jmetrics.psnr(jnp.asarray(out), jnp.asarray(gt))), rtol=1e-6)
    np.testing.assert_allclose(tmetrics.ssim(o, g).item(),
                               float(jmetrics.ssim(jnp.asarray(out), jnp.asarray(gt))), rtol=1e-5)
    pred = (out[..., :1] > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tmetrics.iou(torch.from_numpy(pred), torch.from_numpy(mask)).item(),
        float(jmetrics.iou(jnp.asarray(pred), jnp.asarray(mask))), rtol=1e-6)
    assert tmetrics.ssim(o, o).item() == pytest.approx(1.0, abs=1e-6)
