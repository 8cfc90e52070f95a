"""The port's training ops against the JAX package's, on the CPU: the
partial conv's backward (K3) and train-mode BatchNorm.

K3 is ``PartialConvFunction.backward``; its reference is ``jax.vjp`` of
``ops/partial_conv.py::_partial_conv2d_xla``, whose autodiff is the math
of the Pallas kernel's custom VJP. float32, rtol 1e-4 / atol 1e-5: the
same products, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from text_segmentation_image_inpainting_tpu.ops import partial_conv as jpc
from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import BatchNorm
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import partial_conv2d
from tests.test_torch_bridge import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


RTOL, ATOL = 1e-4, 1e-5


def _case(seed, groups, cout, hw=(9, 11), hole_block=4):
    rng = np.random.default_rng(seed)
    cin = sum(groups)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    m = (rng.random((2, *hw, len(groups))) < 0.6).astype(np.float32)
    m[0, :hole_block, :hole_block] = 0  # windows with no valid tap at all
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal((cout,))).astype(np.float32)
    g = rng.standard_normal((2, *hw, cout)).astype(np.float32)
    return x, m, w, b, g


def _jax_grads(x, m, w, b, g, groups):
    def f(x, w, b):
        y, _ = jpc._partial_conv2d_xla(x, jnp.asarray(m), w, b, groups, (1, 1), (1, 1), (1, 1))
        return y

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _port_grads(x, m, w, b, g, groups):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y, nm = partial_conv2d(xt, torch.from_numpy(m), wt, bt, group_sizes=groups, padding=1)
    assert not nm.requires_grad  # the mask output is binary: no gradient
    y.backward(torch.from_numpy(g))
    return xt.grad.numpy(), wt.grad.numpy().transpose(2, 3, 1, 0), bt.grad.numpy()


@pytest.mark.parametrize("groups,cout", [((12,), 8), ((7, 5), 8), ((12,), 3), ((7, 5), 3)],
                         ids=["G1-K1", "G2-K1", "G1-K2", "G2-K2"])
def test_k3_matches_jax_vjp(groups, cout):
    x, m, w, b, g = _case(sum(groups) + cout, groups, cout)
    want = _jax_grads(x, m, w, b, g, groups)
    got = _port_grads(x, m, w, b, g, groups)
    for name, a, r in zip(("dx", "dW", "db"), got, want):
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL, err_msg=name)


def test_k3_all_hole_windows_pass_no_gradient():
    """A fully masked input gives dx = 0, dW = 0 and db = 0, with no NaN
    from the 1/sum(M) renormalisation."""
    x, m, w, b, g = _case(3, (7, 5), 8)
    m[:] = 0
    for a in _port_grads(x, m, w, b, g, (7, 5)):
        assert np.isfinite(a).all() and (a == 0).all()
    for a, r in zip(_port_grads(x, m, w, b, g, (7, 5)), _jax_grads(x, m, w, b, g, (7, 5))):
        np.testing.assert_array_equal(a, r)


def test_k3_computes_only_the_gradients_asked_for():
    x, m, w, b, g = _case(4, (12,), 8)
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    y, _ = kpc.partial_conv2d_fused(xt, torch.from_numpy(m), wt, None, group_sizes=(12,),
                                    padding=(1, 1))
    (dw,) = torch.autograd.grad(y, [wt], torch.from_numpy(g))
    np.testing.assert_allclose(dw.numpy().transpose(2, 3, 1, 0),
                               _jax_grads(x, m, w, b, g, (12,))[1], rtol=RTOL, atol=ATOL)


@pytest.mark.slow
def test_k3_matches_pallas_custom_vjp_interpret():
    """Against the Pallas kernel's own custom VJP (interpret mode, 8x8)."""
    from text_segmentation_image_inpainting_tpu.ops.pallas.partial_conv_kernel import (
        partial_conv2d_pallas,
    )

    groups = (12, 4)
    for cout in (16, 3):
        x, m, w, b, g = _case(30 + cout, groups, cout, hw=(8, 8))

        def f(x, w, b):
            y, _ = partial_conv2d_pallas(x, jnp.asarray(m), w, b, groups, (1, 1), (1, 1),
                                         (1, 1), True)
            return y

        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
        got = _port_grads(x, m, w, b, g, groups)
        for name, a, r in zip(("dx", "dW", "db"), got, want):
            np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL, err_msg=f"{cout} {name}")


@pytest.mark.parametrize("n,hw", [(8, (1, 1)), (8, (2, 2))], ids=["n8", "n8-spatial"])
def test_batchnorm_train_matches_flax(n, hw):
    """Output, gradient and running statistics of one training step at
    8 values per channel: the size where the running variance must take
    the BIASED batch variance (torch's own BatchNorm would take the
    unbiased one, 8/7 larger)."""
    c = 6
    rng = np.random.default_rng(n + hw[0])
    x = (3.0 + 2.0 * rng.standard_normal((n // hw[0] // hw[1], *hw, c))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(x):
        return bn.apply(variables, x, mutable=["batch_stats"])

    want_y, upd = f(jnp.asarray(x))
    _, vjp = jax.vjp(lambda x: f(x)[0], jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))

    port = BatchNorm(c).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    unbiased = 0.9 * var0 + 0.1 * x.reshape(-1, c).var(0, ddof=1)
    assert not np.allclose(port.running_var.numpy(), unbiased, rtol=1e-3)


def test_batchnorm_frozen_and_eval_use_running_stats():
    port = BatchNorm(4).train()
    x = torch.randn(2, 3, 3, 4) * 5
    before = port.running_var.clone()
    with torch.no_grad():
        frozen = port(x, frozen=True)
        assert torch.equal(port.running_var, before)
        assert torch.equal(frozen, port.eval()(x))
