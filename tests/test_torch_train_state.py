"""The port's optimizer assembly against the JAX package's optax chain, on
the CPU: each ``OptimizerConfig`` branch and schedule over 5 updates on
fixed gradients, parameters equal to rtol 1e-5. Where optax and torch
differ by design (amsgrad's running max, the clip's 1e-6), the test pins
the rule written in ``train/state.py``.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from text_segmentation_image_inpainting_tpu.train import config as jconfig
from text_segmentation_image_inpainting_tpu.train import state as jstate
from text_segmentation_image_inpainting_tpu_torch.train import config as tconfig
from text_segmentation_image_inpainting_tpu_torch.train import state as tstate

SHAPES = {"a": (3, 4), "b": (5,)}


class Params(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        for k, v in init.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _grads(seed, steps=5, shrink=1.0, constant_magnitude=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        g = {}
        for k, s in SHAPES.items():
            v = rng.standard_normal(s).astype(np.float32)
            g[k] = (np.sign(v) if constant_magnitude else v) * np.float32(shrink**i)
        out.append(g)
    return out


def _init():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _run(kw, grads, frozen=()):
    init = _init()
    tx = jstate.make_optimizer(jconfig.OptimizerConfig(**kw))
    if frozen:
        tx = optax.chain(tx, optax.masked(optax.set_to_zero(), {k: k in frozen for k in SHAPES}))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, upd)
    model = Params(init)
    st = tstate.create_train_state(model, tconfig.OptimizerConfig(**kw), frozen=set(frozen))
    for g in grads:
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        st.apply_gradients()
    assert st.step == len(grads)
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: p.detach().numpy() for k, p in model.named_parameters()})


def _assert_same(want, got):
    # atol: a parameter that moved from O(1) towards 0 keeps f32 rounding of O(1)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(kind="adam", learning_rate=1e-2),
    dict(kind="adam", learning_rate=1e-2, weight_decay=0.1),
    dict(kind="sgd", learning_rate=0.1),
    dict(kind="sgd", learning_rate=0.1, beta1=0.0),
    dict(kind="sgd", learning_rate=0.1, weight_decay=0.05),
    dict(kind="adam", learning_rate=1e-2, warmup_steps=3),
    dict(kind="sgd", learning_rate=0.1, warmup_steps=1, restart_period=3, restart_cycles=2),
    dict(kind="sgd", learning_rate=0.1, restart_period=2, restart_cycles=2),
    dict(kind="adam", learning_rate=1e-2, grad_clip_norm=0.5),
    dict(kind="sgd", learning_rate=0.1, grad_clip_norm=0.5),
], ids=["adam", "adamw", "sgd-momentum", "sgd", "sgd-l2", "warmup", "sgdr-warmup", "sgdr",
        "adam-clip", "sgd-clip"])
def test_branch_matches_optax(kw):
    _assert_same(*_run(kw, _grads(1)))


@pytest.mark.parametrize("decay", [0.0, 0.1], ids=["amsgrad", "amsgrad-decoupled-decay"])
def test_amsgrad_matches_optax_while_the_corrected_moment_holds(decay):
    """Gradients of constant magnitude keep the bias-corrected second
    moment constant: there optax's max and torch's max agree."""
    kw = dict(kind="adam", learning_rate=1e-2, amsgrad=True, weight_decay=decay)
    _assert_same(*_run(kw, _grads(2, constant_magnitude=True)))


def test_amsgrad_keeps_torchs_rule_after_a_gradient_shrinks():
    """With shrinking gradients optax (max of the corrected moment) and
    torch (max of the raw moment over the current correction) part: the
    port follows torch's rule, written out here in numpy."""
    lr, b1, b2, eps = 1e-2, 0.9, 0.999, 1e-8
    grads = _grads(3, shrink=0.3)
    want_optax, got = _run(dict(kind="adam", learning_rate=lr, amsgrad=True), grads)
    for k, s in SHAPES.items():
        p = _init()[k].astype(np.float64)
        m = v = vmax = np.zeros(s)
        for t, g in enumerate(grads, start=1):
            m = b1 * m + (1 - b1) * g[k]
            v = b2 * v + (1 - b2) * g[k] ** 2
            vmax = np.maximum(vmax, v)
            p = p - lr / (1 - b1**t) * m / (np.sqrt(vmax) / np.sqrt(1 - b2**t) + eps)
        np.testing.assert_allclose(got[k], p, rtol=1e-5, err_msg=k)
        assert not np.allclose(got[k], want_optax[k], rtol=1e-5), "the rules should part here"


def test_frozen_parameters_never_move():
    want, got = _run(dict(kind="adam", learning_rate=1e-2, grad_clip_norm=0.5), _grads(4),
                     frozen=("b",))
    _assert_same(want, got)
    np.testing.assert_array_equal(got["b"], _init()["b"])


def test_schedules_match_optax():
    for kw in (dict(warmup_steps=4), dict(warmup_steps=2, restart_period=5, restart_cycles=3),
               dict(restart_period=4, restart_cycles=2), {}):
        cfg = tconfig.OptimizerConfig(learning_rate=0.3, **kw)
        if cfg.restart_period:
            sched = optax.sgdr_schedule([dict(
                init_value=0.0 if cfg.warmup_steps else 0.3, peak_value=0.3,
                warmup_steps=cfg.warmup_steps, decay_steps=cfg.restart_period,
                end_value=0.003)] * cfg.restart_cycles)
        elif cfg.warmup_steps:
            sched = optax.linear_schedule(0.0, 0.3, cfg.warmup_steps)
        else:
            sched = lambda count: 0.3  # noqa: E731
        for count in range(20):
            np.testing.assert_allclose(tstate.learning_rate_at(cfg, count), float(sched(count)),
                                       rtol=1e-6, atol=1e-8, err_msg=f"{kw} {count}")
    assert tstate.learning_rate_at(tconfig.OptimizerConfig(warmup_steps=3), 0) == 0.0


def test_configs_have_the_jax_fields_and_defaults():
    for name in ("OptimizerConfig", "SegTrainConfig", "InpaintTrainConfig"):
        t, j = getattr(tconfig, name)(), getattr(jconfig, name)()
        tf, jf = vars(t), vars(j)
        assert sorted(tf) == sorted(jf), name
        for k in jf:
            if k in ("optimizer", "loss"):
                assert vars(tf[k]) == vars(jf[k]), (name, k)
            else:
                assert tf[k] == jf[k], (name, k)


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstate.make_optimizer(tconfig.OptimizerConfig(kind="lamb"), [torch.zeros(1)])
