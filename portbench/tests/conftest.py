"""Fixtures of the benchmark's own tests (``python -m pytest portbench/tests``).

They import the port but never jax: the JAX package is not what the
benchmark measures. Tests that need the card are marked ``gpu`` and skip
inside the ``cuda`` fixture when there is none."""

import copy

import pytest
import torch


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny(cell, dtype: str = "float32"):
    """``cell`` cut to a CPU test's size: 64^2 pages, batches of 2, a
    depth-5 U-Net, the given compute dtype (the VGG trunk's too)."""
    cell.config = copy.deepcopy(cell.config)
    cell.config["image_size"] = [64, 64]
    cell.config["inpainter"]["depth"] = 5
    cell.config["compute_dtype"] = dtype
    cell.traffic = dict(cell.traffic, batch=2, pool_batches=4, warm_batches=2, sample_batches=2,
                        closed_loop_batches=2, span_batches=2, profile_warm=1,
                        profile_batches=3, profile_steps=1)
    if "vgg_dtype" in cell.traffic:
        cell.traffic["vgg_dtype"] = dtype
    return cell
