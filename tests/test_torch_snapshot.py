"""The port's model snapshots (``models/base.py``), the demo and the
leftover ops, against the JAX package on the CPU.

A snapshot written by JAX's ``save_model`` (flax msgpack) is read by the
port's ``load_model`` through its own msgpack reader
(``compat/msgpack.py``) and must equal ``compat/from_jax.py`` of the same
variables bit for bit; ``tolerant_merge`` must report, key for key, what
JAX's reports, the flax paths mapped to state_dict names by running the
bridge on a tree whose leaves carry their own index. Both training CLIs' ``--export`` must round-trip through
``load_model``. The demo draws 64x64 pages and writes its PNG triplets.
``resize_bilinear(align_corners=True)``, ``erode_mask`` and
``conv_output_size`` must equal JAX's (the resize also
tests/fixtures/golden_ops.npz, at JAX's tolerance there).
"""

import logging
import os
from collections.abc import Mapping

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests.test_torch_bridge import (
    SEG_WIDTH,
    jax_segmenter_variables,
    jax_unet_variables,
    one_torch_thread,
)
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu.models import base as jbase
from text_segmentation_image_inpainting_tpu.ops import conv as jconv
from text_segmentation_image_inpainting_tpu.ops import morphology as jmorph
from text_segmentation_image_inpainting_tpu.ops import resize as jresize
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import (
    inpaint_unet_state_dict,
    text_segmenter_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.compat.msgpack import unpackb
from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, TextSegmenter
from text_segmentation_image_inpainting_tpu_torch.models.base import (
    load_model,
    save_model,
    tolerant_merge,
    total_parameters,
)
from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv_output_size
from text_segmentation_image_inpainting_tpu_torch.ops.morphology import erode_mask
from text_segmentation_image_inpainting_tpu_torch.ops.resize import resize_bilinear
from text_segmentation_image_inpainting_tpu_torch.pipeline import demo
from text_segmentation_image_inpainting_tpu_torch.train import run_inpaint, run_seg

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_ops.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def seg_variables():
    return jax_segmenter_variables(JaxTextSegmenter(width_mult=SEG_WIDTH), hw=(32, 32), seed=5)


def _assert_state_equal(module, want):
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = torch.from_numpy(np.array(v)) if not isinstance(v, torch.Tensor) else v
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("kind", ["segmenter", "unet"])
def test_jax_snapshot_loads_bit_equal(tmp_path, seg_variables, kind):
    if kind == "segmenter":
        variables, module = seg_variables, TextSegmenter(width_mult=SEG_WIDTH)
        want = text_segmenter_state_dict(variables)
    else:
        variables = jax_unet_variables(JaxInpaintUNet(depth=3), seed=6)
        module, want = InpaintUNet(depth=3), inpaint_unet_state_dict(variables)
    path = str(tmp_path / "model.msgpack")
    jbase.save_model(path, variables)
    for tolerant in (True, False):
        fresh = type(module)(**({"width_mult": SEG_WIDTH} if kind == "segmenter" else
                                {"depth": 3}))
        assert load_model(path, fresh, tolerant=tolerant) is fresh
        _assert_state_equal(fresh, want)


def test_msgpack_reader_equals_flax():
    """Every type flax writes: maps, lists (as flax stores them), strings,
    integers of each width and sign, floats, nil, booleans, arrays of
    several dtypes (bfloat16 as its exact float32), numpy scalars and
    complex numbers."""
    tree = {
        "params": {"k": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                   "h": np.arange(6, dtype=np.float16), "i": np.arange(300, dtype=np.int8),
                   "b": jnp.arange(5, dtype=jnp.bfloat16) * 1.5, "e": np.zeros((0, 3))},
        "ints": [0, 127, 128, 255, 65536, 1 << 40, -1, -32, -33, -200, -(1 << 40)],
        "s": "x" * 40, "t": True, "f": False, "n": None, "x": 2.5, "c": 1 - 2j,
        "scalar": np.float32(3.5), "long": "y" * 70000,
    }
    raw = serialization.to_bytes(tree)
    got, want = unpackb(raw), serialization.msgpack_restore(raw)

    def compare(a, b, path):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                compare(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (np.ndarray, np.generic)):
            b = np.asarray(b)
            if b.dtype == jnp.bfloat16:
                b = b.astype(np.float32)
            assert np.asarray(a).dtype == b.dtype and np.shape(a) == b.shape, path
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b, path

    compare(got, want, "")
    with pytest.raises(ValueError, match="truncated"):
        unpackb(raw[:-3])


def test_tolerant_merge_reports_what_jax_reports(seg_variables, caplog):
    """decoder_mid 64 loaded into 128: the same keys used and skipped by
    shape (the BN step counters, which flax has not, aside)."""
    small = jax_segmenter_variables(JaxTextSegmenter(width_mult=SEG_WIDTH, decoder_mid=64),
                                    hw=(32, 32), seed=7)
    _, jreport = jbase.tolerant_merge(seg_variables, small)
    loaded = text_segmenter_state_dict(small)
    target = TextSegmenter(width_mult=SEG_WIDTH).state_dict()
    with caplog.at_level(logging.WARNING):
        merged, report = tolerant_merge(target, loaded)
    paths = []  # flax path of leaf i + 1; the bridge keeps each value

    def tag(tree, path=()):
        if isinstance(tree, Mapping):
            return {k: tag(v, path + (k,)) for k, v in tree.items()}
        paths.append("/".join(path))
        return np.full(np.shape(tree), len(paths), np.float64)

    to_port = {paths[int(v.flat[0]) - 1]: key
               for key, v in text_segmenter_state_dict(tag(small)).items()
               if not key.endswith("num_batches_tracked")}
    for what in ("used", "skipped_shape", "skipped_missing", "unfilled"):
        mine = sorted(k for k in report[what] if not k.endswith("num_batches_tracked"))
        assert mine == sorted(to_port[p] for p in jreport[what]), what
    assert len(report["skipped_shape"]) == 31 and report["used"]
    assert sum("shape mismatch" in r.message for r in caplog.records
               if r.name.endswith("_torch.models.base")) == 31
    for k in report["used"]:
        assert torch.equal(merged[k], torch.from_numpy(np.array(loaded[k])).to(target[k].dtype))
    for k in report["skipped_shape"]:
        assert merged[k] is target[k]


def test_tolerant_merge_warns_on_zero_match(caplog):
    target = InpaintUNet(depth=3).state_dict()
    with caplog.at_level(logging.WARNING):
        merged, report = tolerant_merge(target, {"nope.weight": np.zeros(3)})
    assert report["skipped_missing"] == ["nope.weight"] and not report["used"]
    assert len(report["unfilled"]) == len(target)
    assert any("NO keys matched" in r.message for r in caplog.records)
    assert all(merged[k] is target[k] for k in target)


def test_total_parameters_equals_jax(seg_variables):
    assert total_parameters(TextSegmenter(width_mult=SEG_WIDTH)) == jbase.total_parameters(
        seg_variables["params"])


def test_port_snapshot_roundtrip_and_strict_load(tmp_path):
    model = InpaintUNet(depth=3).init_weights(torch.Generator().manual_seed(1))
    path = str(tmp_path / "unet.pt")
    save_model(path, model)
    fresh = load_model(path, InpaintUNet(depth=3), tolerant=False)
    _assert_state_equal(fresh, model.state_dict())
    with pytest.raises(RuntimeError):  # depth 4 has more layers: strict refuses
        load_model(path, InpaintUNet(depth=4), tolerant=False)
    partial = load_model(path, InpaintUNet(depth=4))  # tolerant: the shared layers
    assert torch.equal(partial.enc_convs[0].conv.weight, model.enc_convs[0].conv.weight)


def test_jax_snapshot_of_another_model_is_refused(tmp_path, seg_variables):
    path = str(tmp_path / "seg.msgpack")
    jbase.save_model(path, seg_variables)
    with pytest.raises(ValueError, match="not a InpaintUNet"):
        load_model(path, InpaintUNet(depth=3))


@pytest.mark.parametrize("cli", ["inpaint", "seg"])
def test_export_round_trips(tmp_path, cli):
    path = str(tmp_path / "model.pt")
    if cli == "inpaint":
        state = run_inpaint.main(["--steps", "1", "--batch-size", "2", "--image-size", "32",
                                  "--depth", "3", "--log-every", "1", "--val-batches", "0",
                                  "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
                                  "--export", path])
        fresh = InpaintUNet(depth=3, dtype=torch.bfloat16)
    else:
        state = run_seg.main(["--steps", "1", "--batch-size", "2", "--image-size", "32",
                              "--width-mult", "0.35", "--log-every", "1", "--val-batches", "0",
                              "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
                              "--export", path])
        fresh = TextSegmenter(width_mult=0.35, dtype=torch.bfloat16)
    assert state.step == 1
    _assert_state_equal(load_model(path, fresh, tolerant=False), state.model.state_dict())


def test_demo_writes_triplets(tmp_path, capsys):
    out = tmp_path / "demo"
    demo.main(["--out", str(out), "--pages", "2", "--size", "64", "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert names == sorted(f"page{i}_{s}.png" for i in range(2)
                           for s in ("before", "mask", "after", "gtmask"))
    assert "wrote 2 before/mask/after triplets" in capsys.readouterr().out


def test_demo_loads_snapshots_of_either_format(tmp_path, seg_variables):
    """--seg-ckpt a JAX msgpack snapshot, --unet-ckpt a port snapshot."""
    from PIL import Image

    seg_path = str(tmp_path / "seg.msgpack")
    jbase.save_model(seg_path, jax_segmenter_variables(JaxTextSegmenter(), hw=(32, 32)))
    unet_path = str(tmp_path / "unet.pt")
    save_model(unet_path, InpaintUNet().init_weights(torch.Generator().manual_seed(2)))
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(images / "a.png")
    out = tmp_path / "out"
    demo.main(["--out", str(out), "--pages", "3", "--size", "64", "--device", "cpu",
               "--images", str(images), "--seg-ckpt", seg_path, "--unet-ckpt", unet_path])
    assert sorted(os.listdir(out)) == ["page0_after.png", "page0_before.png", "page0_mask.png"]


def test_demo_never_falls_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device"):
        demo.main(["--out", str(tmp_path / "out"), "--size", "64"])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("hw", [(18, 26), (5, 7), (1, 1), (1, 9), (9, 13), (30, 4)])
def test_resize_align_corners_equals_jax(hw):
    x = np.random.default_rng(4).standard_normal((2, 9, 13, 3)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), hw, align_corners=True))
    got = resize_bilinear(torch.from_numpy(x), hw, align_corners=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_resize_align_corners_golden():
    golden = np.load(FIX)
    got = resize_bilinear(torch.from_numpy(golden["rs_x"]), (18, 26), align_corners=True)
    np.testing.assert_allclose(got.numpy(), golden["rs_ac"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("radius", [0, 1, 2])
def test_erode_mask_equals_jax(radius):
    rng = np.random.default_rng(radius)
    m = (rng.random((2, 12, 15, 2)) > 0.2).astype(np.float32)
    want = np.asarray(jmorph.erode_mask(jnp.asarray(m), radius))
    got = erode_mask(torch.from_numpy(m), radius).numpy()
    np.testing.assert_array_equal(got, want)
    if radius:
        assert 0 < got.sum() < m.sum()


def test_conv_output_size_equals_jax():
    for size in (1, 7, 32, 33):
        for kernel, stride, padding, dilation in [(3, 1, 1, 1), (7, 2, 3, 1), (3, 2, 2, 2),
                                                  (1, 1, 0, 1), (5, 3, 0, 1)]:
            assert conv_output_size(size, kernel, stride, padding, dilation) == \
                jconv.conv_output_size(size, kernel, stride, padding, dilation)
