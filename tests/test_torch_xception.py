"""The port's Xception encoder and DeepLab head
(``models/xception.py``, ``models/text_segmentation.py``) against the
JAX package's, on the CPU.

Narrow models (width 0.25, one middle block, 64x64 pages) carry JAX's
variables (BatchNorm statistics and biases randomised) through
``compat/from_jax.py``; f32 taps and logits are held at rtol 1e-3 /
atol 1e-4. A JAX snapshot of each loads bit-equal. At full width the
encoder routes exactly JAX's 35 layers to K6 (no forward is run), and a
narrow-but-routed encoder's gradients with the flag on (K6's plain
version) equal those with it off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import text_segmentation_image_inpainting_tpu_torch.ops.depthwise as tdw
from tests.test_torch_bridge import jax_segmenter_variables, one_torch_thread, randomize_variables
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu.models import base as jbase
from text_segmentation_image_inpainting_tpu.models.xception import (
    XceptionEncoder as JaxXceptionEncoder,
)
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import (
    load_state_dict,
    text_segmenter_state_dict,
    xception_encoder_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.models import TextSegmenter, XceptionEncoder
from text_segmentation_image_inpainting_tpu_torch.models.base import load_model
from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import ConvBNAct

RTOL, ATOL = 1e-3, 1e-4
HW = (64, 64)
NARROW = dict(width_mult=0.25, middle_repeats=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(autouse=True)
def _restore_flag():
    prev = tdw.USE_CUSTOM_WGRAD
    yield
    tdw.USE_CUSTOM_WGRAD = prev


def _pages(n=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, *HW, 3)).astype(np.float32)


@pytest.mark.parametrize("os_", [8, 16])
def test_encoder_taps_match_jax(os_):
    jm = JaxXceptionEncoder(output_stride=os_, **NARROW)
    v = randomize_variables(jax.jit(jm.init)(jax.random.key(os_), jnp.zeros((1, *HW, 3))), os_)
    x = _pages()
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = XceptionEncoder(output_stride=os_, **NARROW).eval()
    load_state_dict(pm, xception_encoder_state_dict(v))
    got = pm(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == ["out", "s2", "s4"]
    for tap in want:
        assert tuple(got[tap].shape) == want[tap].shape, tap
        np.testing.assert_allclose(got[tap].detach().numpy(), np.asarray(want[tap]), rtol=RTOL,
                                   atol=ATOL, err_msg=tap)
    assert pm.out_channels == jm.out_channels == want["out"].shape[-1]


@pytest.fixture(scope="module")
def deeplab():
    kw = dict(backbone="xception", head="deeplab", **NARROW)
    v = jax_segmenter_variables(JaxTextSegmenter(**kw), hw=HW, seed=3)
    return kw, v


def test_deeplab_segmenter_matches_jax(deeplab):
    kw, v = deeplab
    x = _pages(seed=1)
    want = jax.jit(JaxTextSegmenter(**kw).apply)(v, jnp.asarray(x))
    pm = TextSegmenter(**kw).eval()
    load_state_dict(pm, text_segmenter_state_dict(v))
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, *HW, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_deeplab_on_mobilenet_at_stride_16_matches_jax():
    """The other rate set (6, 12, 18) and the head on the reference's encoder."""
    kw = dict(width_mult=0.35, output_stride=16, head="deeplab")
    v = jax_segmenter_variables(JaxTextSegmenter(**kw), hw=HW, seed=4)
    x = _pages(seed=2)
    want = jax.jit(JaxTextSegmenter(**kw).apply)(v, jnp.asarray(x))
    pm = TextSegmenter(**kw).eval()
    load_state_dict(pm, text_segmenter_state_dict(v))
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert [m[0].dilation[0] for m in pm.decoder.aspp] == [1, 6, 12, 18]


def test_jax_snapshot_loads_bit_equal(deeplab, tmp_path):
    kw, v = deeplab
    path = str(tmp_path / "seg.msgpack")
    jbase.save_model(path, v)
    pm = load_model(path, TextSegmenter(**kw), tolerant=False)
    want = text_segmenter_state_dict(v)
    assert sorted(pm.state_dict()) == sorted(want)
    for k, t in pm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    enc_path = str(tmp_path / "enc.msgpack")
    jbase.save_model(enc_path, {"params": v["params"]["encoder"],
                                "batch_stats": v["batch_stats"]["encoder"]})
    enc = load_model(enc_path, XceptionEncoder(**NARROW), tolerant=False)
    np.testing.assert_array_equal(enc.stem1[0].weight.detach().numpy(),
                                  want["encoder.stem1.0.weight"])


def test_unknown_backbone_and_head_raise_as_in_jax():
    with pytest.raises(ValueError, match="unknown backbone 'resnet'"):
        TextSegmenter(backbone="resnet")
    with pytest.raises(ValueError, match="unknown head 'fpn'"):
        TextSegmenter(head="fpn")


def _k6_layers(model):
    return [(m[0].in_channels, m[0].dilation[0]) for m in model.modules()
            if isinstance(m, ConvBNAct) and tdw.supports(
                m[0].out_channels, m[0].groups, m[0].in_channels, m[0].kernel_size[0],
                m[0].stride[0])]


def test_full_width_k6_scope_is_35_layers():
    """JAX's scope at output stride 8 with 8 middle blocks: every stride-1
    depthwise conv with C >= 128."""
    tdw.USE_CUSTOM_WGRAD = True
    layers = _k6_layers(XceptionEncoder(output_stride=8, middle_repeats=8))
    assert len(layers) == 35
    assert sorted(set(layers)) == [(128, 1), (256, 1), (728, 1), (728, 2), (1024, 2),
                                   (1024, 4), (1536, 4)]
    assert layers.count((728, 2)) == 26
    tdw.USE_CUSTOM_WGRAD = False
    assert not _k6_layers(XceptionEncoder(output_stride=8, middle_repeats=1))


def test_k6_route_gradients_equal_the_stock_ones():
    """width 0.5: the middle flow's 368-channel depthwise convs (d 2) and
    others route to the Function; dW through K6's plain version equals
    autograd's conv weight gradient."""
    torch.manual_seed(0)
    model = XceptionEncoder(width_mult=0.5, output_stride=8, middle_repeats=1).train()
    x = torch.from_numpy(_pages(2, seed=5)[:, :32, :32])

    def grads(flag):
        tdw.USE_CUSTOM_WGRAD = flag
        model.zero_grad(set_to_none=True)
        state = {k: t.clone() for k, t in model.state_dict().items()}
        model(x)["out"].square().mean().backward()
        model.load_state_dict(state)  # the BN statistics as they were
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    tdw.USE_CUSTOM_WGRAD = True
    assert len(_k6_layers(model)) >= 6
    on, off = grads(True), grads(False)
    for n in off:
        np.testing.assert_allclose(on[n].numpy(), off[n].numpy(), rtol=1e-4,
                                   atol=1e-6 * off[n].abs().max().item(), err_msg=n)
