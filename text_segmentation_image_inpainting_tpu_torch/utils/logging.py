"""Structured step logging.

Counterpart of ``text_segmentation_image_inpainting_tpu/utils/logging.py``:
one JSONL record per logged step in ``<log_dir>/<name>.jsonl`` (the same
keys: ``step``, ``time`` and the metrics as floats) and one readable line
on stderr. TensorBoard scalars are opt-in through ``TSIITPU_TENSORBOARD``,
written by ``torch.utils.tensorboard`` where it imports; an import failure
only leaves them off, as in JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time


class MetricLogger:
    def __init__(self, name: str, log_dir: str = "logs"):
        self.name = name
        os.makedirs(log_dir, exist_ok=True)
        self._file = open(os.path.join(log_dir, f"{name}.jsonl"), "a", buffering=1)
        self._tb = None
        if os.environ.get("TSIITPU_TENSORBOARD"):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb", name))
            except Exception:
                pass

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(rec) + "\n")
        pretty = " ".join(f"{k}={v:.4g}" for k, v in rec.items() if k != "time")
        print(f"[{self.name}] {pretty}", file=sys.stderr)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{self.name}/{k}", float(v), step)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
