"""The port's segmentation data and training CLI on the CPU, at a tiny size.

``PageSource('seg')`` gives the JAX package's pages bit for bit (synthetic
and from a data directory); the segmenter's init draws as flax's.
``run_seg`` trains, logs (``logs/seg.jsonl``), checkpoints and resumes
at 32², width 0.35, with the depthwise weight gradients on K6's plain
version; ``--freeze-encoder`` keeps the encoder where it started; the
flags earlier versions of the port refused (the Xception and DeepLab tracks,
accumulation, multi-step dispatch) train; a run that asks for CUDA (the
default) where there is none is refused.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import text_segmentation_image_inpainting_tpu_torch.ops.depthwise as tdw
from tests.test_torch_bridge import (  # noqa: F401 (jax_native_engines: a fixture)
    SEG_WIDTH,
    _reload,
    ensure_jax_native_engines,
    jax_native_engines,
    one_torch_thread,
)
from text_segmentation_image_inpainting_tpu.data.pipeline import PageSource as JaxPageSource
from text_segmentation_image_inpainting_tpu.models import TextSegmenter as JaxTextSegmenter
from text_segmentation_image_inpainting_tpu_torch.compat.from_jax import text_segmenter_state_dict
from text_segmentation_image_inpainting_tpu_torch.data.pipeline import PageSource
from text_segmentation_image_inpainting_tpu_torch.models import TextSegmenter
from text_segmentation_image_inpainting_tpu_torch.train import run_seg
from text_segmentation_image_inpainting_tpu_torch.train.config import SegTrainConfig
from text_segmentation_image_inpainting_tpu_torch.train.val import make_val_batches


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


TINY = ["--batch-size", "2", "--image-size", "32", "--width-mult", "0.35", "--log-every", "1",
        "--val-batches", "1", "--custom-wgrad", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _restore_flag():
    prev = tdw.USE_CUSTOM_WGRAD
    yield
    tdw.USE_CUSTOM_WGRAD = prev


def _logged(start: int = 0):
    """The records ``logs/seg.jsonl`` (in the working directory) holds
    from line ``start`` on."""
    with open("logs/seg.jsonl") as f:
        return [json.loads(line) for line in f.readlines()[start:]]


def _assert_same_pages(got, want):
    assert sorted(got) == sorted(want) == ["image", "mask"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("idx", [0, 5])
def test_seg_pages_equal_jax(idx, jax_native_engines):
    _assert_same_pages(PageSource(kind="seg", size=(48, 40), seed=3)[idx],
                       JaxPageSource(kind="seg", size=(48, 40), seed=3)[idx])


def test_jax_native_engines_repair_a_lost_build(tmp_path, monkeypatch):
    """The race of JAX's in-place build, staged: JAX's page engine pointed
    at a copy of its sources beside a half-written library, so that its
    ``_load`` fails and marks the engine unavailable; the helper rebuilds
    the library, reloads the engine, and the pages are again the port's
    bit for bit (``test_seg_pages_equal_jax``'s comparison)."""
    from text_segmentation_image_inpainting_tpu.data import native_pages as jnp_pages

    ensure_jax_native_engines()
    src = Path(jnp_pages._DIR)
    for f in [src / "Makefile", *src.glob("*.cpp")]:
        shutil.copy2(f, tmp_path)
    lib = tmp_path / "libpagegen.so"
    # a build caught as the linker starts its file (a longer prefix can load
    # and then fault on its missing pages: the race at its worst)
    lib.write_bytes((src / "libpagegen.so").read_bytes()[:16])
    monkeypatch.setattr(jnp_pages, "_DIR", str(tmp_path))
    monkeypatch.setattr(jnp_pages, "_LIB_PATH", str(lib))
    try:
        monkeypatch.setattr(jnp_pages, "_lib", None)
        monkeypatch.setattr(jnp_pages, "_build_failed", False)
        assert not jnp_pages.available() and jnp_pages._build_failed
        ensure_jax_native_engines()
        assert jnp_pages.available() and lib.stat().st_size > 16
        _assert_same_pages(PageSource(kind="seg", size=(48, 40), seed=3)[0],
                           JaxPageSource(kind="seg", size=(48, 40), seed=3)[0])
    finally:
        monkeypatch.undo()
        assert _reload(jnp_pages)  # the engine of the tree again
    assert not any(f.name.startswith("staged-") for f in tmp_path.iterdir())


def test_seg_pages_from_a_data_dir_equal_jax(tmp_path, jax_native_engines):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i, size in enumerate(((50, 70), (20, 24))):  # one needs the upscale
        paths.append(str(tmp_path / f"p{i}.png"))
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(paths[-1])
    for idx in range(3):
        _assert_same_pages(PageSource(kind="seg", size=(32, 32), seed=1, paths=paths)[idx],
                           JaxPageSource(kind="seg", size=(32, 32), seed=1, paths=paths)[idx])


def test_seg_val_batches():
    cfg = SegTrainConfig(image_size=(32, 32), batch_size=2)
    (b,) = make_val_batches("seg", cfg, seed=9, n=1, device="cpu")
    assert b["image"].shape == (2, 32, 32, 3) and b["mask"].shape == (2, 32, 32, 1)
    assert b["image"].dtype == torch.float32
    assert set(torch.unique(b["mask"]).tolist()) <= {0.0, 1.0}


def test_init_weights_follow_flax():
    """``TextSegmenter.init_weights`` (run_seg's init) draws as the JAX
    model's ``init``: LeCun-normal truncated at 2 sigma (sigma^2 = 1 /
    fan_in), so each kernel's spread matches JAX's draw within sampling
    error; biases 0; BatchNorm the identity."""
    want = text_segmenter_state_dict(jax.jit(JaxTextSegmenter(width_mult=SEG_WIDTH).init)(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    got = TextSegmenter(width_mult=SEG_WIDTH).init_weights(torch.Generator().manual_seed(0))
    got = {k: v.numpy() for k, v in got.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if g.ndim == 4:
            std = (1.0 / g[0].size) ** 0.5 / 0.87962566103423978
            assert np.abs(g).max() <= 2 * std * (1 + 1e-6), k
            if g.size >= 1024:
                assert abs(g.std() / np.asarray(w).std() - 1) < 0.15, k
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


def test_trains_checkpoints_and_resumes(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    state = run_seg.main(["--steps", "2", "--ckpt-every", "2", "--ckpt-dir", ckpt, *TINY])
    assert tdw.USE_CUSTOM_WGRAD
    assert state.step == 2 and (tmp_path / "ckpt" / "step_2.pt").exists()
    logs = _logged()
    assert [r["step"] for r in logs] == [1, 2]
    for key in ("bce", "dice", "total", "grad_norm", "val_iou", "val_precision", "val_recall"):
        assert all(np.isfinite(r[key]) for r in logs), key
    assert "pages_per_sec" in logs[1]

    state = run_seg.main(["--steps", "3", "--ckpt-every", "2", "--ckpt-dir", ckpt, *TINY])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert [r["step"] for r in _logged(2)] == [3] and state.step == 3
    saved = torch.load(tmp_path / "ckpt" / "step_2.pt", weights_only=True)
    assert saved["step"] == 2 and sorted(saved) == ["model", "optimizer", "scheduler", "step"]


def test_freeze_encoder_keeps_the_encoder(tmp_path):
    state = run_seg.main(["--steps", "1", "--ckpt-dir", str(tmp_path), "--freeze-encoder",
                          "--seed", "4", *TINY])
    init = TextSegmenter(width_mult=0.35, dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(4))
    start = dict(init.named_parameters())
    for name, p in state.model.named_parameters():
        same = torch.equal(p, start[name])
        assert same == name.startswith("encoder."), name


@pytest.mark.parametrize("flags,item", [
    (["--backbone", "xception"], "item 7"),
    (["--head", "deeplab"], "item 7"),
    (["--grad-accum", "2"], "accum"),
    (["--steps-per-dispatch", "2"], "multistep"),
])
def test_unported_flags_are_refused(tmp_path, monkeypatch, flags, item):
    """The flags earlier versions of the port refused (``item`` names what they waited
    for: ROADMAP Queue 1 item 7, train/accum.py, train/multistep.py) now
    train two steps, as JAX's CLI does."""
    monkeypatch.chdir(tmp_path)
    state = run_seg.main(["--steps", "2", "--ckpt-dir", str(tmp_path / "c"), *TINY,
                          "--log-every", "2", "--ckpt-every", "2", *flags])
    assert state.step == 2 and [r["step"] for r in _logged()] == [2]
    if "--backbone" in flags:
        assert len(state.model.encoder.mid) == 8
    if "--head" in flags:
        assert hasattr(state.model.decoder, "image_pool")


def test_cuda_is_the_default_and_never_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="--device"):
        run_seg.main(["--steps", "1", "--ckpt-dir", str(tmp_path), *tiny])
    assert not any(tmp_path.iterdir())
