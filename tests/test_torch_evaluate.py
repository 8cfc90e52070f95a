"""The port's evaluation CLI (``train/evaluate.py``) against the JAX
package's, on the CPU.

JAX's ``evaluate`` scores closures over one pipeline; the port's scores
``TASKS[task](pipe, batch)``. Both pipelines carry the same weights
(JAX's variables through ``compat/from_jax.py``: a narrow segmenter, a
depth-4 U-Net with the spectral-norm attention block) and score the same
numpy batch (the port draws pages in index order, JAX through grain's
shuffle, so the batches are compared, not the streams), in f32: IoU,
precision, recall, PSNR, SSIM and L1 at rtol 1e-3 / atol 1e-4. The CLI
prints JAX's keys, loads JAX snapshots through ``load_model`` and never
falls back to the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import (
    jax_segmenter_variables,
    jax_unet_variables,
    one_torch_thread,
    port_segmenter,
    port_unet,
)
from text_segmentation_image_inpainting_tpu.models import InpaintUNet as JaxInpaintUNet
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu.models import base as jbase
from text_segmentation_image_inpainting_tpu.pipeline import (
    TextRemovalPipeline as JaxPipeline,
)
from text_segmentation_image_inpainting_tpu.train.metrics import iou, psnr, ssim
from text_segmentation_image_inpainting_tpu_torch.data.pipeline import make_dataset, to_device
from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline
from text_segmentation_image_inpainting_tpu_torch.train import evaluate

SIZE, WIDTH, DEPTH = 64, 0.35, 4
KEYS = {"seg": {"iou", "precision", "recall"}, "inpaint": {"psnr", "ssim", "l1"},
        "pipeline": {"mask_iou"}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def models():
    seg = jax_segmenter_variables(JaxTextSegmenter(width_mult=WIDTH), hw=(SIZE, SIZE), seed=51)
    unet = jax_unet_variables(JaxInpaintUNet(depth=DEPTH, attention=True, attention_sn=True,
                                             fuse_up=False), hw=(SIZE, SIZE), seed=52)
    unet["params"]["attn"]["gamma"] = np.float32(0.5)
    return seg, unet


def _jax_scores(task, seg_vars, unet_vars, batch):
    """JAX ``evaluate``'s closures, on one batch, in f32."""
    pipe = JaxPipeline(seg=JaxTextSegmenter(width_mult=WIDTH),
                       unet=JaxInpaintUNet(depth=DEPTH, attention=True, attention_sn=True,
                                           fuse_up=False),
                       compute_dtype=jnp.float32)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    if task == "seg":
        mask = pipe.segment(seg_vars, b["image"], dilate=False).astype(jnp.float32)
        tp = jnp.sum(mask * b["mask"])
        return {"iou": iou(mask, b["mask"]), "precision": tp / jnp.maximum(jnp.sum(mask), 1e-6),
                "recall": tp / jnp.maximum(jnp.sum(b["mask"]), 1e-6)}
    if task == "inpaint":
        comp = pipe.inpaint(unet_vars, b["image"], 1.0 - b["mask"]).astype(jnp.float32)
        gt = b["image"]
        return {"psnr": psnr(comp, gt), "ssim": ssim(comp, gt),
                "l1": jnp.mean(jnp.abs(comp - gt))}
    raw = pipe.segment(seg_vars, b["image"], dilate=False)
    return {"mask_iou": iou(raw.astype(jnp.float32), b["mask"])}


@pytest.mark.parametrize("task", ["seg", "inpaint", "pipeline"])
def test_scores_match_jax_on_the_same_batch(task, models):
    seg_vars, unet_vars = models
    kind = "inpaint" if task == "inpaint" else "seg"
    batch = next(make_dataset(kind, batch_size=2, size=(SIZE, SIZE), seed=9))
    if task != "inpaint":
        # the segmenter's bias moved so that it predicts some text
        seg_vars = jax.tree.map(np.asarray, seg_vars)
        seg_vars["params"]["decoder"]["head"]["bias"] = np.asarray([0.5], np.float32)
    pipe = TextRemovalPipeline(port_segmenter(seg_vars, width_mult=WIDTH),
                               port_unet(unet_vars, depth=DEPTH, attention=True,
                                         attention_sn=True),
                               compute_dtype=torch.float32).eval()
    got = evaluate.TASKS[task](pipe, to_device(batch, "cpu"))
    want = _jax_scores(task, seg_vars, unet_vars, batch)
    assert set(got) == set(want) == KEYS[task]
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-3, atol=1e-4, err_msg=k)
    if task != "inpaint":
        assert 0.0 < got[next(iter(got))].item() < 1.0  # a real score, not an empty mask's


def test_cli_prints_jax_keys_and_loads_jax_snapshots(models, tmp_path, capsys):
    seg_vars, unet_vars = models
    jbase.save_model(str(tmp_path / "seg.msgpack"), seg_vars)
    jbase.save_model(str(tmp_path / "unet.msgpack"), unet_vars)
    args = ["--batches", "1", "--batch-size", "2", "--size", str(SIZE), "--depth", str(DEPTH),
            "--width-mult", str(WIDTH), "--attention-sn", "--device", "cpu", "--seed", "3",
            "--seg-ckpt", str(tmp_path / "seg.msgpack"),
            "--unet-ckpt", str(tmp_path / "unet.msgpack")]
    for task in KEYS:
        res = evaluate.main(["--task", task, *args])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == res
        assert set(res) == KEYS[task] | {"task", "batches", "batch_size"}
        assert (res["task"], res["batches"], res["batch_size"]) == (task, 1, 2)
        # the same numbers as the bf16 pipeline built from those snapshots
        pipe = evaluate.build_pipeline(evaluate.parse_args(["--task", task, *args])).eval()
        sd = pipe.unet.state_dict()
        np.testing.assert_array_equal(sd["attn.query.u"].numpy(),
                                      unet_vars["spectral"]["attn"]["query"]["u"])
        kind = "inpaint" if task == "inpaint" else "seg"
        batch = next(make_dataset(kind, batch_size=2, size=(SIZE, SIZE), seed=3))
        want = evaluate.TASKS[task](pipe, to_device(batch, "cpu"))
        for k in KEYS[task]:
            assert res[k] == float(want[k]), k


def test_cli_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device"):
        evaluate.main(["--task", "seg", "--batches", "1"])
