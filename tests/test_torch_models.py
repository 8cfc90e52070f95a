"""The PyTorch port's models against the JAX package's, on the CPU.

Same weights (carried across by ``compat/from_jax.py``, with random
BatchNorm statistics and biases), same numpy inputs, eval mode, float32.
Tolerance rtol 1e-3 / atol 1e-4, as tests/test_models_parity.py holds
the JAX models to the torch oracle: the frameworks sum convolutions in
other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import (
    SEG_WIDTH,
    jax_unet_variables,
    one_torch_thread,
    port_segmenter,
    port_unet,
)
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import MobileNetV2Encoder as JaxEncoder
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, MobileNetV2Encoder
from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import round_channels


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def seg():
    from tests.test_torch_bridge import jax_segmenter_variables

    model = JaxTextSegmenter(width_mult=SEG_WIDTH)
    variables = jax_segmenter_variables(model)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return model, variables, port_segmenter(variables, width_mult=SEG_WIDTH), x


def test_round_channels_matches_jax():
    from text_segmentation_image_inpainting_tpu.models.mobilenet_v2 import (
        round_channels as jax_round,
    )

    for c in (16, 24, 32, 96, 160, 320):
        for wm in (0.35, 0.5, 0.75, 1.0, 1.4):
            assert round_channels(c, wm) == jax_round(c, wm)


def test_mobilenet_encoder_taps(seg):
    _, variables, port, x = seg
    enc = JaxEncoder(width_mult=SEG_WIDTH)
    want = jax.jit(enc.apply)(
        {"params": variables["params"]["encoder"],
         "batch_stats": variables["batch_stats"]["encoder"]},
        jnp.asarray(x),
    )
    with torch.no_grad():
        got = port.encoder(torch.from_numpy(x))
    assert isinstance(port.encoder, MobileNetV2Encoder)
    for k in ("s2", "s4", "out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert got["s2"].shape[1] == 32 and got["s4"].shape[1] == 16 and got["out"].shape[1] == 8


@pytest.mark.parametrize("output_stride", [16, 32])
def test_mobilenet_encoder_stride_plans(output_stride):
    """The stride -> dilation swap at the other output strides."""
    from tests.test_torch_bridge import randomize_variables
    from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import (
        load_state_dict,
        mobilenet_v2_encoder_state_dict,
    )

    enc = JaxEncoder(width_mult=SEG_WIDTH, output_stride=output_stride)
    x = np.random.default_rng(output_stride).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    variables = randomize_variables(jax.jit(enc.init)(jax.random.key(1), jnp.asarray(x)), 1)
    want = jax.jit(enc.apply)(variables, jnp.asarray(x))
    port = MobileNetV2Encoder(SEG_WIDTH, output_stride).eval()
    load_state_dict(port, mobilenet_v2_encoder_state_dict(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for k in ("s2", "s4", "out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert got["out"].shape[1] == 64 // output_stride


def test_text_segmenter_logits(seg):
    model, variables, port, x = seg
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_predict_mask(seg):
    model, variables, port, x = seg
    want = np.asarray(model.predict_mask(variables, jnp.asarray(x)))
    got = port.predict_mask(torch.from_numpy(x)).numpy()
    logits = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    near = np.abs(logits) < 1e-4  # sigmoid within float noise of 0.5
    np.testing.assert_array_equal(got[~near], want[~near])


@pytest.mark.parametrize("depth", [3, 4])
def test_inpaint_unet_matches_jax_literal_composition(depth):
    """Against JAX ``InpaintUNet(fuse_up=False)``: the same upsample ->
    concat -> 3x3 partial conv over G=2 groups at every decoder level."""
    jmodel = JaxInpaintUNet(depth=depth, fuse_up=False)
    variables = jax_unet_variables(jmodel, seed=depth)
    rng = np.random.default_rng(depth)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    m = (rng.random((2, 32, 32, 1)) > 0.3).astype(np.float32)
    m[0, :12, :12] = 0  # a hole larger than the deepest level's receptive step
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x * m), jnp.asarray(m)))
    port = port_unet(variables, depth=depth)
    with torch.no_grad():
        got = port(torch.from_numpy(x * m), torch.from_numpy(m)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_inpaint_unet_bf16_near_fused_default():
    """bf16 port against the JAX default (fused half-res phase conv,
    ``fuse_up=True``, forced at 32^2) on the same weights, both scored
    against the float32 result: the port keeps each partial conv's f32
    sum through the epilogue, so it is no further from f32 than JAX's
    own bf16 path (which rounds the conv output before the epilogue)."""
    depth = 3
    jmodel = JaxInpaintUNet(depth=depth, fuse_up=False)
    variables = jax_unet_variables(jmodel, seed=11)
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    m = (rng.random((2, 32, 32, 1)) > 0.3).astype(np.float32)
    xm, mj = jnp.asarray(x * m), jnp.asarray(m)
    f32 = np.asarray(jax.jit(jmodel.apply)(variables, xm, mj))
    fused = JaxInpaintUNet(depth=depth, fuse_min_hw=0, dtype=jnp.bfloat16)
    jax_bf16 = np.asarray(jax.jit(fused.apply)(variables, xm, mj), np.float32)
    port = port_unet(variables, depth=depth, dtype=torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x * m), torch.from_numpy(m)).float().numpy()
    scale = np.abs(f32).max()
    rel_port = np.abs(got - f32).max() / scale
    rel_jax = np.abs(jax_bf16 - f32).max() / scale
    # measured at this seed: port 1.1%, JAX fused 1.4% of max |y|; the
    # 1.5x margin absorbs which of the two a bf16 tie happens to favour
    assert rel_port <= 1.5 * rel_jax, (rel_port, rel_jax)


def test_unet_rejects_indivisible_size():
    with pytest.raises(ValueError, match="divisible"):
        InpaintUNet(depth=3)(torch.zeros(1, 20, 24, 3), torch.ones(1, 20, 24, 1))


def test_compose():
    rng = np.random.default_rng(5)
    out, gt = rng.random((2, 4, 4, 3)), rng.random((2, 4, 4, 3))
    m = (rng.random((2, 4, 4, 1)) > 0.5).astype(np.float64)
    want = np.asarray(JaxInpaintUNet.compose(jnp.asarray(out), jnp.asarray(gt), jnp.asarray(m)))
    got = InpaintUNet.compose(torch.from_numpy(out), torch.from_numpy(gt), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
