"""Spectral-norm conv and SAGAN self-attention: the experiment track.

Counterpart of ``text_segmentation_image_inpainting_tpu/models/experiments.py``:

- :class:`SpectralNormConv2d`: a conv whose kernel is divided by its
  largest singular value, estimated by power iteration (Miyato et al.
  2018) with ``torch.nn.utils.spectral_norm``'s semantics. ``u`` and
  ``v`` are buffers, updated in place only in training forwards (so a
  captured CUDA graph carries them); the weight matrix is the
  (Cout, Cin*kh*kw) flattening of the OIHW kernel.
- :class:`SelfAttention2d`: the SAGAN non-local block (Zhang et al.
  2018): bias-free 1x1 query/key/value projections, key and value
  max-pooled 2x, softmax over positions in f32, a 1x1 output projection
  and a zero-initialised ``gamma`` gate (the block starts as identity).

JAX computes both outside any Pallas kernel, so plain torch ops serve.
Activations are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import apply_conv, flax_init_
from text_segmentation_image_inpainting_tpu_torch.ops.conv import (
    conv2d,
    to_nchw,
    to_nhwc,
    torch_same_padding,
)

_EPS = 1e-12  # torch.nn.utils.spectral_norm's default


def _l2_normalize(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """x / max(||x||, eps), as torch's ``F.normalize``."""
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def spectral_sigma(weight_mat: torch.Tensor, u: torch.Tensor, *, n_iter: int = 1):
    """``n_iter`` power-iteration steps on ``weight_mat`` (Cout, K):
    v = normalize(W^T u); u = normalize(W v); sigma = u^T W v.

    Returns ``(sigma, u_new, v_new)``. The iteration runs on a detached
    W and only the final bilinear form sees the live one, so
    d sigma / dW = u v^T, as in torch's ``spectral_norm``."""
    if n_iter < 1:
        raise ValueError(f"spectral_sigma needs n_iter >= 1, got {n_iter}")
    w32 = weight_mat.float()
    w_iter = w32.detach()
    u = u.detach().float()
    for _ in range(n_iter):
        v = _l2_normalize(w_iter.t() @ u)
        u = _l2_normalize(w_iter @ v)
    sigma = u @ (w32 @ v)
    return sigma, u, v


class SpectralNormConv2d(nn.Conv2d):
    """Conv2d (torch-'same' padding) with a spectral-normalised kernel.

    ``weight`` is stored un-normalised, as torch's ``weight_orig``; the
    buffers ``u`` (Cout,) and ``v`` (Cin*k*k,) hold the power iteration's
    state, JAX's ``'spectral'`` collection. A training forward with
    ``n_power_iterations > 0`` iterates and writes the new pair into the
    buffers in place; eval (and ``n_power_iterations=0``) divides by
    u^T W v of the stored pair."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, bias: bool = True, n_power_iterations: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel_size, stride, torch_same_padding(kernel_size, dilation),
                         dilation=dilation, bias=bias)
        self.n_power_iterations = n_power_iterations
        self.dtype = dtype
        self.register_buffer("u", torch.zeros(cout))
        self.register_buffer("v", torch.zeros(cin * kernel_size * kernel_size))
        self.reset_spectral()

    def weight_mat(self) -> torch.Tensor:
        return self.weight.reshape(self.out_channels, -1)

    @torch.no_grad()
    def reset_spectral(self, generator: torch.Generator | None = None) -> None:
        """u drawn normal and normalised, then the pair after one warm-up
        iteration, as the JAX module stores it at init."""
        u = torch.randn(self.out_channels, generator=generator).to(self.u.device)
        _, u0, v0 = spectral_sigma(self.weight_mat(), _l2_normalize(u))
        self.u.copy_(u0)
        self.v.copy_(v0)

    def sigma(self) -> torch.Tensor:
        if self.training and self.n_power_iterations > 0:
            sigma, u, v = spectral_sigma(self.weight_mat(), self.u, n_iter=self.n_power_iterations)
            with torch.no_grad():
                self.u.copy_(u)
                self.v.copy_(v)
            return sigma
        return self.u.float() @ (self.weight_mat().float() @ self.v.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        kernel = (self.weight / self.sigma()).to(self.dtype)
        return conv2d(x, kernel, self.bias, stride=self.stride, padding=self.padding,
                      dilation=self.dilation)


def _max_pool2(t: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, floor (torch ``MaxPool2d(2)``) on NHWC."""
    return to_nhwc(F.max_pool2d(to_nchw(t), 2))


class SelfAttention2d(nn.Module):
    """SAGAN self-attention over positions, (N,H,W,C) -> (N,H,W,C).

    query 1x1 C -> C/8; key 1x1 C -> C/8, max-pooled 2x; value 1x1
    C -> C/2, max-pooled 2x; attn = softmax(q k^T) from f32 logits, cast
    back; out 1x1 C/2 -> C; y = x + gamma * out with gamma 0 at init.
    ``spectral_norm=True`` makes the projections :class:`SpectralNormConv2d`.
    """

    def __init__(self, channels: int, spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spectral_norm = spectral_norm
        self.dtype = dtype
        c = channels
        self.query = self._proj(c, c // 8)
        self.key = self._proj(c, c // 8)
        self.value = self._proj(c, c // 2)
        self.out = self._proj(c // 2, c)
        self.gamma = nn.Parameter(torch.zeros(()))

    def _proj(self, cin: int, cout: int) -> nn.Conv2d:
        if self.spectral_norm:
            return SpectralNormConv2d(cin, cout, 1, bias=False, dtype=self.dtype)
        return nn.Conv2d(cin, cout, 1, bias=False)

    def _project(self, proj: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return proj(x) if self.spectral_norm else apply_conv(proj, x.to(self.dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> "SelfAttention2d":
        """flax's initialisers, as the JAX block's ``init``: LeCun-normal
        plain projections (flax ``nn.Conv``), He-normal spectral ones
        with their warm-up pair; gamma 0."""
        flax_init_(self, 2.0 if self.spectral_norm else 1.0, generator)
        if self.spectral_norm:
            for proj in (self.query, self.key, self.value, self.out):
                proj.reset_spectral(generator)
        self.gamma.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        q = self._project(self.query, x)
        k = _max_pool2(self._project(self.key, x))
        v = _max_pool2(self._project(self.value, x))
        q = q.reshape(n, h * w, c // 8)
        k = k.reshape(n, -1, c // 8)
        v = v.reshape(n, -1, c // 2)
        # f32 logits: products of bf16 values are exact in f32, as JAX's
        # preferred_element_type=f32
        logits = torch.bmm(q.float(), k.float().transpose(1, 2))
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.bmm(attn, v.to(x.dtype)).reshape(n, h, w, c // 2)
        o = self._project(self.out, o)
        return x + self.gamma.to(x.dtype) * o
