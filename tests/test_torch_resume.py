"""A resumed training run continues the page stream where it stopped.

For both CLIs on the CPU at a tiny size: a run of 2 steps that is resumed
to 4 trains on the same page batches, in the same order, as a straight run
of 4, and ends with bit-equal parameters and statistics. The JAX CLIs
build their stream before they restore the state and start it at the
first batch again; the port differs from them here by design.
"""

import hashlib

import numpy as np
import pytest
import torch

import text_segmentation_image_inpainting_tpu_torch.ops.depthwise as tdw
from text_segmentation_image_inpainting_tpu_torch.data.pipeline import make_dataset
from text_segmentation_image_inpainting_tpu_torch.train import loop, run_inpaint, run_seg
from tests.test_torch_bridge import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


COMMON = ["--batch-size", "2", "--image-size", "32", "--log-every", "4", "--val-batches", "0",
          "--ckpt-every", "2", "--device", "cpu"]
CLIS = {
    "inpaint": (run_inpaint, ["--depth", "3", "--fused-stem"]),
    "seg": (run_seg, ["--width-mult", "0.35"]),
}


@pytest.fixture(autouse=True)
def _restore_wgrad_flag():
    flag = tdw.USE_CUSTOM_WGRAD
    yield
    tdw.USE_CUSTOM_WGRAD = flag


def _digest(batch: dict) -> str:
    h = hashlib.sha256()
    for key in sorted(batch):
        h.update(np.ascontiguousarray(batch[key]).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("kind", ["inpaint", "seg"])
@pytest.mark.parametrize("start", [0, 3, 8])
def test_make_dataset_start_skips_pages(kind, start):
    """``make_dataset(start=k)`` is the stream from 0 without its first k
    pages, also where k is no multiple of the batch size."""
    kw = dict(batch_size=2, size=(32, 32), seed=5)
    from_zero = make_dataset(kind, **kw)
    batches = [next(from_zero) for _ in range(6)]
    pages = {k: np.concatenate([b[k] for b in batches]) for k in ("image", "mask")}
    shifted = make_dataset(kind, start=start, **kw)
    for i in range(2):
        batch = next(shifted)
        for key, want in pages.items():
            lo = start + 2 * i
            np.testing.assert_array_equal(batch[key], want[lo:lo + 2])


@pytest.mark.parametrize("kind", ["inpaint", "seg"])
def test_resumed_run_sees_the_same_batches(kind, tmp_path, monkeypatch, capsys):
    cli, flags = CLIS[kind]
    seen = []
    real = loop.to_device

    def recording(batch, device):
        seen.append(_digest(batch))
        return real(batch, device)

    monkeypatch.setattr(loop, "to_device", recording)

    def run(steps, ckpt):
        seen.clear()
        state = cli.main(["--steps", str(steps), "--ckpt-dir", str(tmp_path / ckpt), *COMMON,
                          *flags])
        return state, list(seen)

    straight, batches = run(4, "straight")
    assert len(set(batches)) == 4
    _, first = run(2, "resumed")
    resumed, second = run(4, "resumed")
    assert "resumed from step 2" in capsys.readouterr().out
    assert first + second == batches
    assert resumed.step == straight.step == 4
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    assert want.keys() == got.keys()
    for name in want:
        assert torch.equal(want[name], got[name]), name
