"""The port's segmentation losses against the JAX package's, on the CPU.

Same numpy logits and targets, float32: every term of
``segmentation_loss`` (with and without ``pos_weight``, with and without
focal) agree to rtol 1e-6, and the gradient of the total to 1e-6 of
its own value or of its largest element (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_segmentation_image_inpainting_tpu.losses import segmentation as jseg
from text_segmentation_image_inpainting_tpu_torch.losses import segmentation as tseg
from tests.test_torch_bridge import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


RTOL = 1e-6


def _case(seed, shape=(3, 16, 12, 1)):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    targets = (rng.random(shape) < 0.15).astype(np.float32)
    return logits, targets


@pytest.mark.parametrize("pos_weight", [None, 3.0], ids=["plain", "pos-weight"])
@pytest.mark.parametrize("focal_weight", [0.0, 0.5], ids=["no-focal", "focal"])
def test_every_term_and_the_gradient_match_jax(pos_weight, focal_weight):
    logits, targets = _case(int(focal_weight * 10) + (pos_weight is not None))
    kw = dict(bce_weight=1.0, dice_weight=1.0, focal_weight=focal_weight, pos_weight=pos_weight)

    def f(x):
        return jseg.segmentation_loss(x, jnp.asarray(targets), **kw)

    (_, want), vjp = jax.vjp(f, jnp.asarray(logits))
    (want_grad,) = vjp((jnp.ones(()), jax.tree.map(jnp.zeros_like, want)))
    lt = torch.from_numpy(logits).requires_grad_(True)
    total, got = tseg.segmentation_loss(lt, torch.from_numpy(targets), **kw)
    total.backward()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL, err_msg=k)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(lt.grad.numpy(), want_grad, rtol=RTOL,
                               atol=RTOL * np.abs(want_grad).max())


@pytest.mark.parametrize("name", ["bce_with_logits", "dice_loss", "focal_loss"])
def test_each_loss_promotes_bf16_to_f32_as_jax(name):
    logits, targets = _case(7)
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    got = getattr(tseg, name)(lb, torch.from_numpy(targets))
    want = getattr(jseg, name)(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_term_weights_select_the_terms():
    logits, targets = _case(8)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    total, terms = tseg.segmentation_loss(lt, tt, bce_weight=0.0, dice_weight=2.0)
    assert sorted(terms) == ["dice", "total"]
    assert total.item() == pytest.approx(2.0 * terms["dice"].item(), rel=1e-6)
