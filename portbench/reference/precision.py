"""How the plain reference rounds the operands of its products.

``F32`` is the reference itself: nothing is rounded, and TF32 is kept off
(``no_tf32``), so every product is a true float32 product. ``FP8`` is the
benchmark's lower-precision control: the configuration states bfloat16,
and the next precision below it is fp8. The reference then computes as
the program computes in its own dtype, one step lower: every product
takes its inputs in float8 e4m3 and accumulates in f32, and every tensor
held between layers (a conv's, BatchNorm's or activation's output, a
residual sum, the page) is rounded to e4m3, each under a per-tensor scale
(amax to 448, as fp8 training scales them); in the backward pass the
gradient reaching each of those tensors is rounded to e5m2. Losses,
reductions and Adam stay f32. ``BF16`` rounds the same tensors to
bfloat16 (no scale): what the configuration's own precision does to the
reference, read by ``calibrate.py`` as a witness.

A ``Precision`` may also carry a ``records`` list: every product then
appends its kind, multiply-adds, geometry and whether its input and weight
need a gradient, which ``work.py`` reads on the meta device to count
useful FLOPs and to list the layers a kernel serves.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


def _scaled(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` under a per-tensor scale that maps amax to the
    format's largest finite value, returned in x's dtype."""
    if x.device.type == "meta":
        return x
    if torch.finfo(dtype).bits > 8:  # wide range: no scale needed
        return x.to(dtype).to(x.dtype)
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Round(torch.autograd.Function):
    """Forward: x rounded to ``fwd``; backward: the gradient rounded to ``bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return x if fwd is None else _scaled(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.bwd is None else _scaled(g, ctx.bwd)), None, None


@dataclasses.dataclass
class Precision:
    name: str
    fwd: torch.dtype | None = None  # operand format of every product
    bwd: torch.dtype | None = None  # format of the gradient reaching a product's output
    records: list | None = None

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A product's input."""
        if self.fwd is None:
            return x
        return _Round.apply(x, self.fwd, None)

    def store(self, y: torch.Tensor) -> torch.Tensor:
        """A tensor held between layers, and the gradient that reaches it."""
        if self.fwd is None and self.bwd is None:
            return y
        return _Round.apply(y, self.fwd, self.bwd if y.requires_grad else None)

    def value(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor held in the compute precision (the pipeline's page)."""
        return x if self.fwd is None else _scaled(x, self.fwd)

    def record(self, kind: str, macs: float, x_grad: bool, w_grad: bool, **shape) -> None:
        """One product: its multiply-adds, whether its input and its weight
        need a gradient, and its geometry (``shape``: x, w, stride, ...)."""
        if self.records is not None:
            self.records.append(dict(kind=kind, macs=float(macs), x_grad=bool(x_grad),
                                     w_grad=bool(w_grad), **shape))


def f32() -> Precision:
    return Precision("f32")


def fp8() -> Precision:
    return Precision("fp8", torch.float8_e4m3fn, torch.float8_e5m2)


def bf16() -> Precision:
    """The reference at the configurations' own precision: a witness of what
    bfloat16 rounding alone does to a number, never a control."""
    return Precision("bf16", torch.bfloat16, torch.bfloat16)


PRECISIONS = {"f32": f32, "fp8": fp8, "bf16": bf16}


@contextlib.contextmanager
def no_tf32():
    """True float32 products on the card while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
