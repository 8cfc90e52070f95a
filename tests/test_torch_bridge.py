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


def one_torch_thread():
    """Generator for a module fixture: torch's CPU ops on one thread, then
    the count restored. The test workers share the host's cores, and each
    worker's pool of intra-op threads would oversubscribe them: every op
    then waits for threads that are not running (the serving tests took
    20-100x longer under six workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    every module of the port (the multi-device ``parallel`` package too),
    a synthetic training page of each kind drawn through the port's own
    generators, a serving batch through its prefetcher, whole and over a
    2-entry mesh, and a page through the pipeline over 2 H bands
    (``ops/bands.py``, ``spatial_pipeline_run``), load neither jax nor flax
    nor any module of the JAX package."""
    code = (
        "import sys\n"
        "import text_segmentation_image_inpainting_tpu_torch.pipeline\n"
        "import text_segmentation_image_inpainting_tpu_torch.compat.from_jax\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.kernels.build\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.kernels.partial_conv\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.kernels.vgg_stem\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.kernels.depthwise_wgrad\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.depthwise\n"
        "import text_segmentation_image_inpainting_tpu_torch.models.vgg\n"
        "import text_segmentation_image_inpainting_tpu_torch.losses\n"
        "import text_segmentation_image_inpainting_tpu_torch.losses.segmentation\n"
        "import text_segmentation_image_inpainting_tpu_torch.train\n"
        "import text_segmentation_image_inpainting_tpu_torch.train.seg\n"
        "import text_segmentation_image_inpainting_tpu_torch.train.run_inpaint\n"
        "import text_segmentation_image_inpainting_tpu_torch.train.run_seg\n"
        "import text_segmentation_image_inpainting_tpu_torch.pipeline.serve\n"
        "import text_segmentation_image_inpainting_tpu_torch.pipeline.sparse\n"
        "import text_segmentation_image_inpainting_tpu_torch.pipeline.demo\n"
        "import text_segmentation_image_inpainting_tpu_torch.models.base\n"
        "import text_segmentation_image_inpainting_tpu_torch.compat.msgpack\n"
        "import text_segmentation_image_inpainting_tpu_torch.compat.torchvision\n"
        "import text_segmentation_image_inpainting_tpu_torch.compat.verify_pretrained\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.resize\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.morphology\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.conv\n"
        "import text_segmentation_image_inpainting_tpu_torch.ops.bands\n"
        "import text_segmentation_image_inpainting_tpu_torch.models.experiments\n"
        "import text_segmentation_image_inpainting_tpu_torch.models.xception\n"
        "import text_segmentation_image_inpainting_tpu_torch.train.accum\n"
        "import text_segmentation_image_inpainting_tpu_torch.train.multistep\n"
        "import text_segmentation_image_inpainting_tpu_torch.train.evaluate\n"
        "import text_segmentation_image_inpainting_tpu_torch.utils.logging\n"
        "import text_segmentation_image_inpainting_tpu_torch.utils.profiling\n"
        "import text_segmentation_image_inpainting_tpu_torch.parallel\n"
        "import text_segmentation_image_inpainting_tpu_torch.parallel.mesh\n"
        "import text_segmentation_image_inpainting_tpu_torch.parallel.spatial\n"
        "import text_segmentation_image_inpainting_tpu_torch.parallel.stage_pipeline\n"
        "from text_segmentation_image_inpainting_tpu_torch.data.pipeline import (\n"
        "    DevicePrefetcher, PageSource, make_page_stream_u8)\n"
        "for kind in ('seg', 'inpaint'):\n"
        "    assert PageSource(kind=kind, size=(32, 32))[0]['mask'].shape == (32, 32, 1)\n"
        "pf = DevicePrefetcher(make_page_stream_u8(2, (32, 32)), device='cpu')\n"
        "assert next(pf)['image'].shape == (2, 32, 32, 3)\n"
        "pf.close()\n"
        "from text_segmentation_image_inpainting_tpu_torch.parallel import make_mesh\n"
        "pf = DevicePrefetcher(make_page_stream_u8(2, (32, 32)), mesh=make_mesh(2, platform='cpu'))\n"
        "assert [p['image'].shape for p in next(pf)] == [(1, 32, 32, 3)] * 2\n"
        "pf.close()\n"
        "import torch\n"
        "from text_segmentation_image_inpainting_tpu_torch.models import (\n"
        "    InpaintUNet, TextSegmenter)\n"
        "from text_segmentation_image_inpainting_tpu_torch.parallel import spatial_pipeline_run\n"
        "from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline\n"
        "pipe = TextRemovalPipeline(TextSegmenter(width_mult=0.35), InpaintUNet(depth=3),\n"
        "                           compute_dtype=torch.float32).eval()\n"
        "clean, _ = spatial_pipeline_run(make_mesh(2, platform='cpu'), pipe,\n"
        "                                torch.rand(1, 16, 16, 3))\n"
        "assert clean.shape == (1, 16, 16, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'text_segmentation_image_inpainting_tpu'))\n"
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
