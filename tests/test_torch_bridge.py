"""The PyTorch port's weight bridge, and its freedom from jax.

Also holds the helpers the other ``test_torch_*`` files share: init a
JAX module, randomise its BatchNorm statistics and biases (so every BN
fold and bias path does real work), and carry the variables into the
port with ``compat/from_jax.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from text_segmentation_image_inpainting_tpu.compat.torch_export import (
    export_inpaint_unet,
    export_text_segmenter,
)
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import (
    inpaint_unet_state_dict,
    load_state_dict,
    text_segmenter_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, TextSegmenter

REPO = Path(__file__).resolve().parents[1]
SEG_WIDTH = 0.35  # narrow MobileNetV2: every block kind, a fraction of the compute


def randomize_variables(variables, seed: int):
    """Random BN affine and running stats, random biases (numpy seed)."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = traverse_util.flatten_dict(jax.device_get(tree))
        for path, v in flat.items():
            v = np.asarray(v)
            name = path[-1]
            if name == "bias" or name == "mean":
                v = 0.1 * rng.standard_normal(v.shape)
            elif name == "scale":
                v = 1.0 + 0.1 * rng.standard_normal(v.shape)
            elif name == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            flat[path] = np.asarray(v, np.float32)
        out[col] = traverse_util.unflatten_dict(flat)
    return out


def jax_segmenter_variables(model, hw=(64, 64), seed=0):
    x = jnp.zeros((1, *hw, 3), jnp.float32)
    return randomize_variables(jax.jit(model.init)(jax.random.key(seed), x), seed)


def jax_unet_variables(model, hw=(32, 32), seed=0):
    x = jnp.zeros((1, *hw, 3), jnp.float32)
    m = jnp.ones((1, *hw, 1), jnp.float32)
    return randomize_variables(jax.jit(model.init)(jax.random.key(seed), x, m), seed)


def port_segmenter(variables, **kw):
    model = TextSegmenter(**kw).eval()
    load_state_dict(model, text_segmenter_state_dict(variables))
    return model


def port_unet(variables, **kw):
    model = InpaintUNet(**kw).eval()
    load_state_dict(model, inpaint_unet_state_dict(variables))
    return model


@pytest.fixture(scope="module")
def seg_variables():
    return jax_segmenter_variables(JaxTextSegmenter(width_mult=SEG_WIDTH))


def _assert_same_state_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_segmenter_bridge_equals_torch_export(seg_variables):
    """Key for key and value for value the JAX package's own exporter."""
    _assert_same_state_dict(
        text_segmenter_state_dict(seg_variables), export_text_segmenter(seg_variables)
    )


def test_segmenter_bridge_loads_strict(seg_variables):
    model = port_segmenter(seg_variables, width_mult=SEG_WIDTH)
    sd = text_segmenter_state_dict(seg_variables)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


@pytest.mark.parametrize("depth", [3, 4])
def test_unet_bridge_equals_torch_export_and_loads_strict(depth):
    variables = jax_unet_variables(JaxInpaintUNet(depth=depth, fuse_up=False), seed=depth)
    sd = inpaint_unet_state_dict(variables)
    _assert_same_state_dict(sd, export_inpaint_unet(variables, depth=depth))
    model = port_unet(variables, depth=depth)
    assert len(model.state_dict()) == len(sd)


def test_bridge_rejects_a_mismatched_model(seg_variables):
    """strict=True: a wrong width is an error, not a partial load."""
    with pytest.raises(RuntimeError):
        port_segmenter(seg_variables, width_mult=1.0)


def test_port_imports_no_jax_or_flax():
    """In a fresh interpreter (this one has jax loaded by the conftest):
    every module of the port, and a synthetic training page drawn through
    the JAX package's framework-free generators."""
    code = (
        "import sys\n"
        "import text_segmentation_image_inpainting_tpu_torch.pipeline\n"
        "import text_segmentation_image_inpainting_tpu_torch.compat.from_jax\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.kernels.build\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.kernels.partial_conv\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.kernels.vgg_stem\n"
        "import text_segmentation_image_inpainting_tpu_torch.models.vgg\n"
        "import text_segmentation_image_inpainting_tpu_torch.losses\n"
        "import text_segmentation_image_inpainting_tpu_torch.train\n"
        "import text_segmentation_image_inpainting_tpu_torch.train.run_inpaint\n"
        "from text_segmentation_image_inpainting_tpu_torch.data.pipeline import PageSource\n"
        "assert PageSource(size=(32, 32))[0]['mask'].shape == (32, 32, 1)\n"
        "import text_segmentation_image_inpainting_tpu.data.masks\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "clean", proc.stderr


def test_weights_are_float32_parameters_whatever_the_compute_dtype():
    """bf16 modules keep f32 parameters, as flax ``param_dtype=f32``."""
    model = InpaintUNet(depth=3, dtype=torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
