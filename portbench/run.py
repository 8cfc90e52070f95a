#!/usr/bin/env python3
"""The port's benchmark, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``text_segmentation_image_inpainting_tpu_torch``). It needs
a CUDA device and never falls back to the CPU; see ``harness.py``.
"""

import os
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the caches a library might keep stay inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "portbench", "out", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "portbench", "out", "triton"))

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(t0=min(T0, harness.process_start())))
