"""Weights from the run's seed, made on the device in two draws.

Every tensor of a state dict (the reference's names, which the program's
modules share) is cut from one normal draw and one uniform draw of a
``torch.Generator`` on the device:

  conv kernels     He-normal, N(0, 2 / fan_in)
  conv biases      N(0, 0.1^2)
  BN weight, bias  1 + N(0, 0.1^2), BN_SHIFT + N(0, 0.1^2)
  running mean     N(0, 0.1^2)
  running var      0.5 + U(0, 1)

so every BatchNorm does real work in eval mode too. The same seed gives
the same weights on the same kind of device.

BN_SHIFT puts a normalised channel mostly in its activation's linear
range (ReLU6 clips 2% of it), as in a trained network. At a shift of 0
these random networks are chaotic: a rounding grows by about 1.2x a
MobileNetV2 block, and the segmenter's bf16 and f32 logits differ by 27%
of their spread on average, which no comparison of outputs could tell
from a fault; at 2 they differ by 2.4%, and fp8 by 11x that.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit generator seed for the named stream of run ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), zlib.crc32(stream.encode())])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


BN_SHIFT = 2.0


def _kind(name: str, t: torch.Tensor, names) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return "count"
    if leaf in ("running_mean", "running_var"):
        return leaf
    if t.dim() == 4:
        return "kernel"
    if leaf == "bias":
        return "bn_bias" if name[:-4] + "running_mean" in names else "bias"
    return "scale"  # a BatchNorm weight


@torch.no_grad()
def make_weights(shapes: dict, seed: int, stream: str, device) -> dict:
    """{name: tensor} on ``device`` for every entry of ``shapes`` ({name:
    template tensor}, a state dict), drawn from (seed, stream)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    kinds = {k: _kind(k, t, shapes) for k, t in shapes.items()}
    n_norm = sum(t.numel() for k, t in shapes.items()
                 if kinds[k] not in ("count", "running_var"))
    n_unif = sum(t.numel() for k, t in shapes.items() if kinds[k] == "running_var")
    normal = torch.randn(n_norm, generator=gen, device=device)
    uniform = torch.rand(max(n_unif, 1), generator=gen, device=device)
    out, i, j = {}, 0, 0
    for k, t in shapes.items():
        kind, n = kinds[k], t.numel()
        if kind == "count":
            out[k] = torch.zeros(t.shape, dtype=t.dtype, device=device)
            continue
        if kind == "running_var":
            out[k] = 0.5 + uniform[j:j + n].view(t.shape)
            j += n
            continue
        z = normal[i:i + n].view(t.shape)
        i += n
        if kind == "kernel":
            out[k] = z * (2.0 / t[0].numel()) ** 0.5
        elif kind == "scale":
            out[k] = 1.0 + 0.1 * z
        elif kind == "bn_bias":
            out[k] = BN_SHIFT + 0.1 * z
        else:  # bias, running_mean
            out[k] = 0.1 * z
    return out
