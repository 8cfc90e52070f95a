"""Checkpoints of a ``TrainState`` with ``torch.save``, and resume-latest.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/checkpoint.py``
(Orbax there): ``save(step, state)`` every ``save_interval_steps``,
keeping the newest ``max_to_keep``; ``restore_latest(state)`` loads the
newest into ``state`` in place. Saves are synchronous, so ``wait`` has
nothing to wait for; it and ``close`` keep the JAX interface.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_NAME = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3, save_interval_steps: int = 1):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.fullmatch(p.name)))

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> bool:
        """Save at multiples of ``save_interval_steps``; True if saved."""
        if step % self.save_interval_steps or step in self._steps():
            return False
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)  # atomic: a reader never sees a partial file
        for old in self._steps()[: -self.max_to_keep]:
            self._path(old).unlink()
        return True

    def restore_latest(self, state):
        """(state, step) with the newest checkpoint loaded into ``state``;
        (state, None) when there is none."""
        step = self.latest_step()
        if step is None:
            return state, None
        state.load_state_dict(torch.load(self._path(step), map_location="cpu", weights_only=True))
        return state, step

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass
