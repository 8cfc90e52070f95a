"""The port's pretrained-weight path: torchvision ``mobilenet_v2`` and
``vgg16`` files into the port's names (``compat/torchvision.py``), the
runbook (``compat/verify_pretrained.py``) and ``run_inpaint --vgg-ckpt``.

On the CPU the name tables are held bit for bit to the JAX package's
importers (``import_torchvision_mobilenetv2``, ``import_vgg16_features``,
carried over by ``compat/from_jax.py``), the port's segmenter at imported
weights to JAX's at the tolerance of ``tests/test_torch_models.py``, and
the runbook's float64 walk to the port's modules; its gates fail on a
shape-corrupted file, a file missing a block and a file in the port's own
names. The files are fabricated from a seed: no real weight file is in the
repository.

Tests marked ``gpu`` skip without a CUDA device (decided in a fixture) and
run on the card with

    python -m pytest -m gpu --noconftest tests/test_torch_pretrained.py

The card has no jax: this file imports it only inside the CPU tests.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from text_segmentation_image_inpainting_tpu_torch.compat import verify_pretrained as vp
from text_segmentation_image_inpainting_tpu_torch.compat.torchvision import (
    load_torch_file,
    mobilenet_name_pairs,
    tolerant_import,
    torchvision_mobilenet_v2_state_dict,
    vgg16_features_state_dict,
)
from text_segmentation_image_inpainting_tpu_torch.models import (
    InpaintUNet,
    MobileNetV2Encoder,
    TextSegmenter,
)
from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import flax_init_
from text_segmentation_image_inpainting_tpu_torch.models.vgg import VGG16Features

REPO = Path(__file__).resolve().parents[1]
REPORT_LOGGER = "text_segmentation_image_inpainting_tpu_torch.compat.torchvision"
NBT = "num_batches_tracked"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores (the
    # helper in test_torch_bridge.py imports jax, which the card lacks)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Fabricated torchvision files: vgg16 with every feature conv and the
    classifier stand-ins, mobilenet_v2 with features.18 and classifier.1."""
    return vp.fabricate(str(tmp_path_factory.mktemp("fab")), seed=0)


def numpy_torchvision_mobilenet(seed: int) -> dict:
    """A torchvision-layout mobilenet_v2 state_dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(rng.integers(1, 1000), np.int64) if k.endswith(NBT)
                else rng.standard_normal(s).astype(np.float32))
            for k, s in vp.mobilenet_v2_layout().items()}


def _save_variant(src: str, dst: Path, edit) -> str:
    sd = torch.load(src, weights_only=True)
    edit(sd)
    torch.save(sd, dst)
    return str(dst)


# -- the name tables against JAX's importers ---------------------------------

def test_mobilenet_table_equals_jax_importer():
    """torchvision names -> the port's, bit for bit JAX's import carried
    over by the port's flax bridge: the same 255 weights and statistics,
    the same 51 BatchNorm counters, features.18 and classifier dropped."""
    pytest.importorskip("jax")
    from text_segmentation_image_inpainting_tpu.compat.torch_import import (
        import_torchvision_mobilenetv2,
    )
    from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import (
        mobilenet_v2_encoder_state_dict,
    )

    tv = numpy_torchvision_mobilenet(0)
    got = torchvision_mobilenet_v2_state_dict(tv)
    want = mobilenet_v2_encoder_state_dict(import_torchvision_mobilenetv2(tv))
    weights = sorted(k for k in want if not k.endswith(NBT))
    assert len(weights) == 255 and sorted(k for k in got if not k.endswith(NBT)) == weights
    assert sorted(k for k in got if k.endswith(NBT)) == sorted(k for k in want if k.endswith(NBT))
    assert len(got) == 255 + 51
    for k in weights:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not any(k.startswith(("features", "classifier")) for k in got)


def test_mobilenet_table_pairs_cover_both_block_forms():
    pairs = mobilenet_name_pairs()
    assert pairs[:2] == [("features.0.0", "stem.0"), ("features.0.1", "stem.1")]
    block1 = [tv for tv, _ in pairs if tv.startswith("features.1.")]
    block2 = [tv for tv, port in pairs if tv.startswith("features.2.")]
    assert block1 == [f"features.1.conv.{s}" for s in ("0.0", "0.1", "1", "2")]
    assert block2 == [f"features.2.conv.{s}" for s in ("0.0", "0.1", "1.0", "1.1", "2", "3")]
    assert len(pairs) == 2 + 4 + 16 * 6 and pairs[-1] == ("features.17.conv.3", "blocks.16.block.3")


def test_mobilenet_table_loads_strictly_into_a_segmenter():
    """With prefix 'encoder.' the renamed file is exactly a TextSegmenter's
    encoder keys, and loads with strict=True."""
    tv = {k: torch.from_numpy(np.asarray(v)) for k, v in numpy_torchvision_mobilenet(1).items()}
    sd = torchvision_mobilenet_v2_state_dict(tv, prefix="encoder.")
    seg = TextSegmenter(width_mult=1.0, output_stride=8)
    assert set(sd) == {k for k in seg.state_dict() if k.startswith("encoder.")}
    seg.load_state_dict({**seg.state_dict(), **sd}, strict=True)
    for k, v in sd.items():
        assert torch.equal(seg.state_dict()[k], v), k


def test_vgg_table_equals_jax_importer():
    pytest.importorskip("jax")
    from text_segmentation_image_inpainting_tpu.compat.torch_import import import_vgg16_features
    from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import (
        vgg16_features_state_dict as from_jax_vgg,
    )

    rng = np.random.default_rng(2)
    tv = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in vp.vgg16_layout().items()}
    got = vgg16_features_state_dict(tv)
    want = from_jax_vgg(import_vgg16_features(tv))
    assert sorted(got) == sorted(want) == sorted(VGG16Features().state_dict())
    assert len(got) == 14
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the runbook's plain walk against the port's modules ---------------------

@pytest.mark.parametrize("size", [32, 64])
def test_runbook_walk_matches_the_encoder(files, size):
    out = vp.verify_mobilenet(files["mobilenet"], size, torch.device("cpu"))
    assert out["ok"], out
    assert out["coverage"] == {"used": 255, "skipped_shape": 0, "skipped_missing": 0,
                               "unfilled": 0}
    assert set(out["tap_max_abs_err"]) == {"s2", "s4", "out"}
    assert not out["segmenter_encoder_unfilled"]


@pytest.mark.parametrize("size", [32, 64])
def test_runbook_walk_matches_vgg(files, size):
    out = vp.verify_vgg16(files["vgg16"], size, torch.device("cpu"))
    assert out["ok"], out
    assert out["coverage"]["used"] == 14 and out["coverage"]["skipped_missing"] == 0
    assert max(out["tap_max_abs_err"].values()) < vp.TOL_VGG


def test_plain_walk_is_the_dilated_encoder(files):
    """The walk's taps at output stride 8: s2 at 1/2, s4 at 1/4, out at 1/8
    (the last stages dilated, not strided), and within the encoder's
    tolerance of the port at the imported weights."""
    sd = load_torch_file(files["mobilenet"])
    x = torch.from_numpy(np.random.default_rng(3).random((2, 48, 40, 3)).astype(np.float32))
    want = vp.plain_mobilenet_v2(sd, x)
    assert [tuple(want[k].shape) for k in ("s2", "s4", "out")] == [
        (2, 24, 20, 32), (2, 12, 10, 24), (2, 6, 5, 320)]
    enc = MobileNetV2Encoder(1.0, 8).eval()
    tolerant_import(enc, torchvision_mobilenet_v2_state_dict(sd))
    with torch.no_grad():
        got = enc(x)
    for k, w in want.items():
        assert (got[k].double() - w).abs().max() <= vp.TOL_ENCODER * max(1.0, w.abs().max()), k


def test_segmenter_at_imported_weights_matches_jax(files):
    """The port's TextSegmenter with the port's import of the file, against
    JAX's with JAX's import of it; the decoder's weights are the same on
    both sides. Logits at 64^2 within rtol 1e-3 / atol 1e-4."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from text_segmentation_image_inpainting_tpu.compat.torch_import import (
        import_text_segmenter,
        import_torchvision_mobilenetv2,
    )
    from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter

    sd = load_torch_file(files["mobilenet"])
    port = TextSegmenter(width_mult=1.0, output_stride=8).init_weights(
        torch.Generator().manual_seed(4))
    tolerant_import(port, torchvision_mobilenet_v2_state_dict(sd, prefix="encoder."))
    port.eval()
    dec = import_text_segmenter({k: v.numpy() for k, v in port.state_dict().items()})
    enc = import_torchvision_mobilenetv2({k: v.numpy() for k, v in sd.items()}, path=("encoder",))
    variables = {c: {**dec[c], "encoder": enc[c]["encoder"]} for c in ("params", "batch_stats")}
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    model = JaxTextSegmenter(width_mult=1.0, output_stride=8)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


# -- the gates fail when they should -----------------------------------------

def test_shape_corrupted_files_fail(files, tmp_path):
    def bad_vgg(sd):
        sd["features.2.weight"] = torch.zeros(7, 7, 3, 3)  # wrong out-channels

    def bad_mobilenet(sd):
        sd["features.5.conv.1.0.weight"] = torch.zeros(192, 2, 3, 3)

    out = vp.verify_vgg16(_save_variant(files["vgg16"], tmp_path / "v.pth", bad_vgg), 32,
                          torch.device("cpu"))
    assert not out["ok"] and out["coverage"]["skipped_shape"] == 1
    assert out["tap_max_abs_err"] is None
    out = vp.verify_mobilenet(_save_variant(files["mobilenet"], tmp_path / "m.pth",
                                            bad_mobilenet), 32, torch.device("cpu"))
    assert not out["ok"] and out["coverage"]["skipped_shape"] == 1
    assert out["segmenter_encoder_unfilled"] == []  # the mismatch is a skip, not a gap


def test_a_file_missing_a_block_fails(files, tmp_path):
    def drop_block(sd):
        for k in [k for k in sd if k.startswith("features.7.")]:
            del sd[k]

    out = vp.verify_mobilenet(_save_variant(files["mobilenet"], tmp_path / "m.pth", drop_block),
                              32, torch.device("cpu"))
    assert not out["ok"]
    assert out["coverage"]["used"] == 255 - 15 and out["coverage"]["unfilled"] == 15
    assert out["segmenter_encoder_unfilled"][0].startswith("encoder.blocks.6.block.")


@pytest.mark.parametrize("module", ["encoder", "segmenter"])
def test_port_layout_passed_as_torchvision_fails(tmp_path, module):
    """A file in the port's own names (the research layout) matches no
    torchvision name: nothing is used and the gate fails."""
    m = MobileNetV2Encoder(1.0, 8) if module == "encoder" else TextSegmenter(1.0, 8)
    path = tmp_path / "port.pth"
    torch.save(m.state_dict(), path)
    out = vp.verify_mobilenet(str(path), 32, torch.device("cpu"))
    assert not out["ok"]
    assert out["coverage"]["used"] == 0 and out["coverage"]["unfilled"] == 255


# -- the CLI -----------------------------------------------------------------

def test_cli_on_the_cpu(tmp_path, capsys):
    rc = vp.main(["--device", "cpu", "--fabricate", str(tmp_path / "fab"), "--size", "32",
                  "--finetune", "8", "--finetune-size", "32", "--finetune-batch", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    verdict = json.loads(lines[0])
    assert verdict["ok"] and verdict["device"] == "cpu"
    assert verdict["vgg16"]["ok"] and verdict["mobilenet_v2"]["ok"]
    ft = verdict["finetune_smoke"]
    assert ft["ok"] and ft["steps"] == 8 and ft["loss_last_quarter"] < ft["loss_first_quarter"]
    assert (tmp_path / "fab" / "vgg16.pth").exists()


def test_cli_exits_1_on_a_corrupted_file(files, tmp_path):
    """``python -m`` in a fresh interpreter: one verdict line, ok false, exit 1."""
    def bad(sd):
        sd["features.12.bias"] = torch.zeros(3)

    path = _save_variant(files["vgg16"], tmp_path / "bad.pth", bad)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "text_segmentation_image_inpainting_tpu_torch.compat."
         "verify_pretrained", "--device", "cpu", "--vgg16", path, "--size", "32"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 1 and len(lines) == 1, proc.stderr
    verdict = json.loads(lines[0])
    assert not verdict["ok"] and verdict["vgg16"]["coverage"]["skipped_shape"] == 1


def test_cli_refuses_cuda_without_a_card(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cuda"):
        vp.main(["--vgg16", files["vgg16"]])


def test_eval_leg(files, tmp_path, monkeypatch):
    """Skipped without the trained snapshot, as JAX's; with one (here a
    port snapshot of a fresh segmenter) it scores under evaluate's keys."""
    monkeypatch.setattr(vp, "TRAINED_SEG", tmp_path / "absent.msgpack")
    cpu = torch.device("cpu")
    out = vp.eval_with_encoder(files["mobilenet"], 32, 1, cpu)
    assert out == {"skipped": f"no trained snapshot at {tmp_path / 'absent.msgpack'}"}
    from text_segmentation_image_inpainting_tpu_torch.models.base import save_model

    snap = tmp_path / "seg.pt"
    save_model(str(snap), TextSegmenter().init_weights(torch.Generator().manual_seed(6)))
    monkeypatch.setattr(vp, "TRAINED_SEG", snap)
    out = vp.eval_with_encoder(files["mobilenet"], 32, 1, cpu)
    assert {"iou", "precision", "recall"} <= set(out) and out["task"] == "seg"
    assert all(np.isfinite(out[k]) for k in ("iou", "precision", "recall"))


# -- run_inpaint --vgg-ckpt ---------------------------------------------------

def test_load_vgg_is_tolerant(files, tmp_path, caplog):
    """A file without features.14 loads (the strict loader refused it): the
    other convs take the file's values, features.14 keeps the random
    weights drawn from the generator, and one report line says so."""
    from text_segmentation_image_inpainting_tpu_torch.train.run_inpaint import load_vgg

    def drop(sd):
        del sd["features.14.weight"], sd["features.14.bias"]

    path = _save_variant(files["vgg16"], tmp_path / "partial.pth", drop)
    caplog.set_level(logging.INFO, logger=REPORT_LOGGER)
    vgg = load_vgg(VGG16Features(), path, torch.Generator().manual_seed(7))
    assert ("tolerant_import: used 12, skipped 0 (missing) / 0 (shape), unfilled 2"
            in caplog.text)
    sd = torch.load(path, weights_only=True)
    template = VGG16Features()
    flax_init_(template, 1.0, torch.Generator().manual_seed(7))
    for k, v in vgg.state_dict().items():
        assert torch.equal(v, template.state_dict()[k] if "features.14." in k else sd[k]), k


@pytest.mark.parametrize("variant", ["full", "partial"])
def test_run_inpaint_vgg_ckpt(files, tmp_path, monkeypatch, caplog, capsys, variant):
    """The CLI with a full torchvision vgg16.pth (deeper convs and the
    classifier included) and with one that lacks features.14: both train,
    and the report is logged."""
    from text_segmentation_image_inpainting_tpu_torch.train import run_inpaint

    path = files["vgg16"]
    if variant == "partial":
        def drop(sd):
            del sd["features.14.weight"], sd["features.14.bias"]

        path = _save_variant(path, tmp_path / "partial.pth", drop)
    monkeypatch.chdir(tmp_path)
    caplog.set_level(logging.INFO, logger=REPORT_LOGGER)
    state = run_inpaint.main(["--steps", "1", "--batch-size", "2", "--image-size", "32",
                              "--depth", "3", "--log-every", "1", "--val-batches", "1",
                              "--fused-stem", "--device", "cpu", "--ckpt-dir", str(tmp_path / "c"),
                              "--vgg-ckpt", path])
    want = "used 14" if variant == "full" else "used 12"
    assert f"tolerant_import: {want}" in caplog.text
    assert "random VGG16 weights" not in capsys.readouterr().out
    with open("logs/inpaint.jsonl") as f:
        record = json.loads(f.readline())
    assert state.step == 1 and np.isfinite(record["total"])


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the runbook's cuda leg and the kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_runbook_on_the_card(cuda, tmp_path, capsys):
    tf32 = torch.backends.cudnn.allow_tf32
    rc = vp.main(["--device", "cuda", "--fabricate", str(tmp_path / "fab"), "--size", "64",
                  "--finetune", "8", "--finetune-size", "32", "--finetune-batch", "2"])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and verdict["ok"], verdict
    assert verdict["device"] == torch.cuda.get_device_name(cuda)
    assert verdict["mobilenet_v2"]["coverage"]["used"] == 255
    assert torch.backends.cudnn.allow_tf32 == tf32  # off for the parity only


@pytest.mark.gpu
def test_imported_pipeline_launches_the_kernels(cuda, files):
    """``run`` with the imported encoder: K1 7 and K2 1, binary masks,
    non-text pixels bit-identical to the input."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline

    bf = torch.bfloat16
    pipe = TextRemovalPipeline(TextSegmenter(1.0, 8, dtype=bf), InpaintUNet(depth=8, dtype=bf))
    pipe.init_weights(torch.Generator().manual_seed(0))
    report = tolerant_import(pipe.seg, torchvision_mobilenet_v2_state_dict(
        load_torch_file(files["mobilenet"]), prefix="encoder."))
    assert vp.coverage_counts(report)["used"] == 255
    pipe = pipe.to(cuda).eval()
    pages = torch.rand((2, 256, 256, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0
    clean, text = pipe.run(pages)
    torch.cuda.synchronize()
    assert (kpc.K1_LAUNCHES, kpc.K2_LAUNCHES) == (7, 1)
    assert torch.isfinite(clean).all() and ((text == 0) | (text == 1)).all()
    keep = (text == 0).expand_as(clean)
    assert torch.equal(clean[keep], pages.to(bf)[keep])
