"""The port's experiment track (``models/experiments.py``: spectral norm
and SAGAN self-attention; ``InpaintUNet(attention, attention_sn)``)
against the JAX package's, on the CPU.

The same weights (carried by ``compat/from_jax.py``, or by hand for a
lone spectral-norm conv) and the same numpy inputs go through both; f32
outputs, u/v and gradients are held at rtol 1e-3 / atol 1e-4 (the
models' bound, ``tests/test_torch_models.py``). ``gamma`` is set off 0,
so the attention branch counts. A JAX snapshot with its ``'spectral'``
collection loads bit-equal, and a training checkpoint keeps u and v
(the counterpart of JAX's ``test_checkpoint_roundtrip_with_spectral_state``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests.test_torch_bridge import jax_unet_variables, one_torch_thread
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import experiments as jexp
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import (
    inpaint_unet_state_dict,
    load_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet
from text_segmentation_image_inpainting_tpu_torch.models.base import load_model, save_model
from text_segmentation_image_inpainting_tpu_torch.models.experiments import (
    SelfAttention2d,
    SpectralNormConv2d,
    spectral_sigma,
)
from text_segmentation_image_inpainting_tpu_torch.train.checkpoint import CheckpointManager
from text_segmentation_image_inpainting_tpu_torch.train.config import OptimizerConfig
from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _sn_pair(cin=6, cout=10, k=3, stride=1, dilation=1, bias=True, n_iter=1, seed=0):
    """A JAX SpectralNormConv2d's variables (bias random) and the port's
    module carrying them."""
    jm = jexp.SpectralNormConv2d(cout, k, stride=stride, dilation=dilation, use_bias=bias,
                                 n_power_iterations=n_iter)
    v = jax.device_get(jm.init(jax.random.key(seed), jnp.zeros((1, 12, 12, cin))))
    v = jax.tree.map(np.asarray, v)
    if bias:
        v["params"]["bias"] = np.random.default_rng(seed).normal(0, 0.1, cout).astype(np.float32)
    pm = SpectralNormConv2d(cin, cout, k, stride=stride, dilation=dilation, bias=bias,
                            n_power_iterations=n_iter)
    sd = {"weight": v["params"]["kernel"].transpose(3, 2, 0, 1),
          "u": v["spectral"]["u"], "v": v["spectral"]["v"]}
    if bias:
        sd["bias"] = v["params"]["bias"]
    load_state_dict(pm, sd)
    return jm, v, pm


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(stride=2, bias=False), dict(k=1, dilation=2)],
                         ids=["3x3", "stride-2-no-bias", "1x1"])
def test_spectral_norm_conv_eval_matches_jax(kw):
    jm, v, pm = _sn_pair(**kw)
    x = _x((2, 12, 12, 6))
    want = jm.apply(v, jnp.asarray(x))
    got = pm.eval()(torch.from_numpy(x))
    _close(got.detach(), want)


def test_spectral_norm_conv_training_forward_moves_u_v_as_jax():
    jm, v, pm = _sn_pair()
    x = _x((2, 12, 12, 6))
    want, mut = jm.apply(v, jnp.asarray(x), update_stats=True, mutable=["spectral"])
    got = pm.train()(torch.from_numpy(x))
    _close(got.detach(), want, "out")
    _close(pm.u, mut["spectral"]["u"], "u")
    _close(pm.v, mut["spectral"]["v"], "v")
    assert not np.allclose(pm.u.numpy(), v["spectral"]["u"], rtol=0, atol=0)
    # eval and n_power_iterations=0 read the stored pair: no move
    for module in (pm.eval(), _sn_pair(n_iter=0)[2].train()):
        u = module.u.clone()
        module(torch.from_numpy(x))
        assert torch.equal(module.u, u)


def test_spectral_norm_conv_gradient_matches_jax():
    """d sigma / dW = u v^T: the power iteration sees a detached W."""
    jm, v, pm = _sn_pair()
    x, g = _x((2, 12, 12, 6)), _x((2, 12, 12, 10), seed=2)

    def loss(params):
        out, _ = jm.apply({"params": params, "spectral": v["spectral"]}, jnp.asarray(x),
                          update_stats=True, mutable=["spectral"])
        return jnp.sum(out * g)

    want = jax.grad(loss)(v["params"])
    pm.train()
    (pm(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    _close(pm.weight.grad, np.asarray(want["kernel"]).transpose(3, 2, 0, 1), "dW")
    _close(pm.bias.grad, want["bias"], "db")


def test_spectral_sigma_matches_jax_over_iterations():
    w = _x((10, 54))
    u = _x((10,), seed=3)
    for n in (1, 3):
        want = jexp.spectral_sigma(jnp.asarray(w), jnp.asarray(u), n_iter=n)
        got = spectral_sigma(torch.from_numpy(w), torch.from_numpy(u), n_iter=n)
        for a, b in zip(got, want):
            _close(a, b)
    with pytest.raises(ValueError, match="n_iter"):
        spectral_sigma(torch.from_numpy(w), torch.from_numpy(u), n_iter=0)


@pytest.mark.parametrize("sn", [False, True], ids=["plain", "spectral-norm"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_self_attention_matches_jax(sn, train):
    c = 32
    jm = jexp.SelfAttention2d(spectral_norm=sn)
    x = _x((2, 6, 8, c))
    v = jax.tree.map(np.asarray, jax.device_get(jm.init(jax.random.key(4), jnp.asarray(x))))
    v["params"]["gamma"] = np.float32(0.8)
    pm = SelfAttention2d(c, spectral_norm=sn)
    sd = {"gamma": v["params"]["gamma"]}
    for name in ("query", "key", "value", "out"):
        sd[f"{name}.weight"] = v["params"][name]["kernel"].transpose(3, 2, 0, 1)
        if sn:
            sd[f"{name}.u"], sd[f"{name}.v"] = v["spectral"][name]["u"], v["spectral"][name]["v"]
    load_state_dict(pm, sd)
    if sn and train:
        want, mut = jm.apply(v, jnp.asarray(x), update_stats=True, mutable=["spectral"])
    else:
        want = jm.apply(v, jnp.asarray(x))
    got = pm.train(train)(torch.from_numpy(x))
    _close(got.detach(), want)
    if sn and train:
        for name in ("query", "key", "value", "out"):
            _close(getattr(pm, name).u, mut["spectral"][name]["u"], name)


def test_self_attention_init():
    """gamma 0 (the block starts as the identity); u and v the warm-up
    pair of the drawn weights, as JAX stores them at init."""
    block = SelfAttention2d(64, spectral_norm=True).init_weights(torch.Generator().manual_seed(0))
    assert block.gamma.item() == 0.0
    x = torch.from_numpy(_x((1, 4, 4, 64)))
    assert torch.equal(block.eval()(x), x)
    for proj in (block.query, block.key, block.value, block.out):
        assert abs(proj.u.norm().item() - 1) < 1e-5 and abs(proj.v.norm().item() - 1) < 1e-5
        _, u1, v1 = spectral_sigma(proj.weight_mat(), proj.u)
        # one more iteration from a converging pair moves it little
        assert float(u1 @ proj.u) > 0.5 and float(v1 @ proj.v) > 0.5


@pytest.fixture(scope="module")
def attn_unet():
    jm = JaxInpaintUNet(depth=4, attention=True, attention_sn=True, fuse_up=False)
    v = jax_unet_variables(jm, hw=(64, 64), seed=5)
    v["params"]["attn"]["gamma"] = np.float32(0.6)
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    m = (rng.random((2, 64, 64, 1)) > 0.3).astype(np.float32)
    return jm, v, x * m, m


def _port_unet(v):
    pm = InpaintUNet(depth=4, attention=True, attention_sn=True)
    load_state_dict(pm, inpaint_unet_state_dict(v))
    return pm


def test_attention_unet_matches_jax(attn_unet):
    jm, v, x, m = attn_unet
    pm = _port_unet(v)
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(m))
    _close(pm.eval()(torch.from_numpy(x), torch.from_numpy(m)).detach(), want, "eval")
    want, mut = jm.apply(v, jnp.asarray(x), jnp.asarray(m), train=True,
                         mutable=["batch_stats", "spectral"])
    got = pm.train()(torch.from_numpy(x), torch.from_numpy(m))
    _close(got.detach(), want, "train")
    for name in ("query", "key", "value", "out"):
        _close(getattr(pm.attn, name).u, mut["spectral"]["attn"][name]["u"], name)
        _close(getattr(pm.attn, name).v, mut["spectral"]["attn"][name]["v"], name)
    _close(pm.dec_bns[0].running_mean, mut["batch_stats"]["dec3_bn"]["mean"], "BN")


def test_attention_unet_jax_snapshot_loads_bit_equal(attn_unet, tmp_path):
    from text_segmentation_image_inpainting_tpu.models import base as jbase

    _, v, x, m = attn_unet
    path = str(tmp_path / "unet.msgpack")
    jbase.save_model(path, v)
    pm = load_model(path, InpaintUNet(depth=4, attention=True, attention_sn=True),
                    tolerant=False)
    want = inpaint_unet_state_dict(v)
    assert sorted(pm.state_dict()) == sorted(want)
    assert {"attn.gamma", "attn.query.u", "attn.out.v"} <= set(want)
    for k, t in pm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    # and the port's own snapshot keeps u and v
    save_model(str(tmp_path / "unet.pt"), pm)
    again = load_model(str(tmp_path / "unet.pt"), InpaintUNet(depth=4, attention=True,
                                                                attention_sn=True))
    for k, t in again.state_dict().items():
        assert torch.equal(t, pm.state_dict()[k]), k
    assert serialization.msgpack_restore(open(path, "rb").read())["spectral"]


def test_checkpoint_round_trip_keeps_u_v(tmp_path):
    model = InpaintUNet(depth=3, attention=True, attention_sn=True).init_weights(
        torch.Generator().manual_seed(7))
    state = create_train_state(model, OptimizerConfig(kind="sgd", learning_rate=1e-2))
    with torch.no_grad():
        model.attn.query.u.copy_(torch.linspace(-1, 1, model.attn.query.u.numel()))
    state.step = 7
    ckpt = CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1)
    assert ckpt.save(7, state)
    ckpt.wait()
    fresh = InpaintUNet(depth=3, attention=True, attention_sn=True)
    restored, step = ckpt.restore_latest(create_train_state(fresh, OptimizerConfig(kind="sgd")))
    ckpt.close()
    assert step == 7 and restored.step == 7
    for k, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
