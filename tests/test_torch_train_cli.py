"""The port's training CLI end to end on the CPU, at a tiny size: it trains,
logs (``logs/inpaint.jsonl``), checkpoints and resumes; it loads a
torchvision VGG16 state_dict and decodes a data directory; its logged
numbers depend on ``--seed`` alone; the flags earlier versions of the port refused
(accumulation, multi-step dispatch, the attention track) train; a run
that asks for CUDA (the default) where there is none is refused.
"""

import json

import numpy as np
import pytest
import torch

from text_segmentation_image_inpainting_tpu_torch.train import run_inpaint
from tests.test_torch_bridge import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


TINY = ["--batch-size", "2", "--image-size", "32", "--depth", "3", "--log-every", "1",
        "--val-batches", "1", "--fused-stem", "--device", "cpu"]


def _logged(start: int = 0):
    """The records ``logs/inpaint.jsonl`` (in the working directory) holds
    from line ``start`` on."""
    with open("logs/inpaint.jsonl") as f:
        return [json.loads(line) for line in f.readlines()[start:]]


def test_trains_checkpoints_and_resumes(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    state = run_inpaint.main(["--steps", "2", "--ckpt-every", "2", "--ckpt-dir", ckpt, *TINY])
    assert state.step == 2 and (tmp_path / "ckpt" / "step_2.pt").exists()
    logs = _logged()
    assert [r["step"] for r in logs] == [1, 2]
    for key in ("total", "valid", "hole", "perceptual", "style_out", "style_comp", "tv",
                "val_psnr", "val_ssim", "val_l1"):
        assert all(np.isfinite(r[key]) for r in logs), key
    assert "pages_per_sec" in logs[1]

    state = run_inpaint.main(["--steps", "3", "--ckpt-every", "2", "--ckpt-dir", ckpt, *TINY])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert [r["step"] for r in _logged(2)] == [3] and state.step == 3
    saved = torch.load(tmp_path / "ckpt" / "step_2.pt", weights_only=True)
    assert saved["step"] == 2 and sorted(saved) == ["model", "optimizer", "scheduler", "step"]


def test_vgg_checkpoint_and_data_dir(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from PIL import Image

    from text_segmentation_image_inpainting_tpu_torch.models.vgg import VGG16Features

    sd = {f"features.{k}": v for k, v in VGG16Features().features.state_dict().items()}
    sd["classifier.6.bias"] = torch.zeros(1000)
    torch.save(sd, tmp_path / "vgg16.pth")
    data = tmp_path / "pages"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i, size in enumerate(((40, 48), (20, 24))):  # one needs the upscale
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(data / f"p{i}.PNG")
    run_inpaint.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "c"), "--vgg-ckpt",
                      str(tmp_path / "vgg16.pth"), "--data-dir", str(data), *TINY])
    out = capsys.readouterr().out
    assert "random VGG16 weights" not in out
    assert np.isfinite(_logged()[0]["total"])
    with pytest.raises(SystemExit, match="no image files"):
        run_inpaint.main(["--steps", "1", "--data-dir", str(tmp_path / "c"), *TINY])


@pytest.mark.parametrize("flags,item", [
    (["--grad-accum", "2"], "accum"),
    (["--steps-per-dispatch", "2"], "multistep"),
    (["--attention"], "attention"),
    (["--attention-sn"], "attention"),
])
def test_unported_flags_are_refused(tmp_path, monkeypatch, flags, item):
    """The flags earlier versions of the port refused (``item`` names what they waited
    for: train/accum.py, train/multistep.py, the attention track) now train
    two steps, as JAX's CLI does."""
    monkeypatch.chdir(tmp_path)
    state = run_inpaint.main(["--steps", "2", "--ckpt-dir", str(tmp_path / "c"), *TINY,
                              "--log-every", "2", "--ckpt-every", "2", *flags])
    assert state.step == 2 and [r["step"] for r in _logged()] == [2]
    if item == "attention":
        assert state.model.attn is not None
        assert state.model.attn.spectral_norm == ("--attention-sn" in flags)


def test_cuda_is_the_default_and_never_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="--device"):
        run_inpaint.main(["--steps", "1", "--ckpt-dir", str(tmp_path), *tiny])
    assert not any(tmp_path.iterdir())


def test_metrics_depend_on_the_seed_alone(tmp_path, monkeypatch):
    """The random VGG16 trunk is drawn from ``--seed`` as the U-Net is: the
    process-global torch RNG changes nothing that is logged."""
    monkeypatch.chdir(tmp_path)
    logs = []
    for i, global_seed in enumerate((1, 7)):
        torch.manual_seed(global_seed)
        run_inpaint.main(["--steps", "1", "--seed", "3", "--ckpt-dir", str(tmp_path / str(i)),
                          *TINY])
        logs.append(_logged(i))
    assert [[r["step"] for r in run] for run in logs] == [[1], [1]]
    for run in logs:
        run[0].pop("pages_per_sec", None)
        run[0].pop("time")
    assert logs[0] == logs[1]
