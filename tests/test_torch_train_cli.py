"""The port's training CLI end to end on the CPU, at a tiny size: it trains,
logs, checkpoints and resumes; it loads a torchvision VGG16 state_dict
and decodes a data directory; flags whose machinery is not ported are
refused by name.
"""

import json

import numpy as np
import pytest
import torch

from text_segmentation_image_inpainting_tpu_torch.train import run_inpaint

TINY = ["--batch-size", "2", "--image-size", "32", "--depth", "3", "--log-every", "1",
        "--val-batches", "1", "--fused-stem"]


def _logged(out: str):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_trains_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    state = run_inpaint.main(["--steps", "2", "--ckpt-every", "2", "--ckpt-dir", ckpt, *TINY])
    assert state.step == 2 and (tmp_path / "ckpt" / "step_2.pt").exists()
    logs = _logged(capsys.readouterr().out)
    assert [r["step"] for r in logs] == [1, 2]
    for key in ("total", "valid", "hole", "perceptual", "style_out", "style_comp", "tv",
                "val_psnr", "val_ssim", "val_l1"):
        assert all(np.isfinite(r[key]) for r in logs), key
    assert "pages_per_sec" in logs[1]

    state = run_inpaint.main(["--steps", "3", "--ckpt-every", "2", "--ckpt-dir", ckpt, *TINY])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert [r["step"] for r in _logged(out)] == [3] and state.step == 3
    saved = torch.load(tmp_path / "ckpt" / "step_2.pt", weights_only=True)
    assert saved["step"] == 2 and sorted(saved) == ["model", "optimizer", "scheduler", "step"]


def test_vgg_checkpoint_and_data_dir(tmp_path, capsys):
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
    assert np.isfinite(_logged(out)[0]["total"])
    with pytest.raises(SystemExit, match="no image files"):
        run_inpaint.main(["--steps", "1", "--data-dir", str(tmp_path / "c"), *TINY])


@pytest.mark.parametrize("flags,item", [
    (["--grad-accum", "2"], "accum"),
    (["--steps-per-dispatch", "2"], "multistep"),
    (["--attention"], "attention"),
    (["--attention-sn"], "attention"),
    (["--export", "model.msgpack"], "snapshot"),
])
def test_unported_flags_are_refused(tmp_path, flags, item):
    with pytest.raises(SystemExit, match=item):
        run_inpaint.main(["--steps", "1", "--ckpt-dir", str(tmp_path), *TINY, *flags])
    assert not any(tmp_path.iterdir())
