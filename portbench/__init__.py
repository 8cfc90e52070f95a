"""The port's benchmark: see ``harness.py`` and ``BENCHMARK.json``."""
