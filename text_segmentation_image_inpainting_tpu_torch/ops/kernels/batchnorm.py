"""BatchNorm's glue (statistics, normalisation, activation, cast) on CUDA, and its plain version.

Replaces no TPU kernel: the JAX package runs flax's ``BatchNorm`` under
XLA, which fuses the glue. The CUDA source is ``csrc/batchnorm.cu``: on
NHWC activations seen as (rows, C), ``bn_stats`` takes the batch's
E[x] and E[x^2] and ``bn_apply`` writes ``act((x - mean) * scale + b)``
cast to x's dtype, forward; ``bn_bwd_reduce`` takes the sums of the
cotangent g and of g * xhat and ``bn_bwd_dx`` writes dx, backward. Eval
and frozen mode normalise by the running statistics in ``bn_apply`` alone.
``bn_plan`` (pure Python, CPU-tested) chooses the channel vectors, the
CTAs' threads and the grid.

``batchnorm`` routes by what it can see in its input: a tensor on the
CPU, or of another dtype than bf16 and f32, takes ``batchnorm_plain``
(the eager chain in flax's arithmetic, the kernels' yardstick); a CUDA
bf16 or f32 tensor launches the kernels or raises, nothing falls back.
``count("bn.kernel")`` and ``count("bn.plain")``
(``utils/profiling.py``) count the calls of each route, ``BN_LAUNCHES``
the kernels' launches.

Under ``ops/collectives.py::data_parallel`` the statistics are the global
batch's: the pair (E[x], E[x^2]) is summed over the ranks between
``bn_stats`` and ``bn_apply`` and divided by their number, and the pair
(Sum g, Sum g xhat) is summed before ``bn_bwd_dx``, both through
``collectives.all_reduce_stats``; so the gradient through the statistics
crosses ranks as the plain version's does. The weight's and bias's
gradients stay the rank's own, as the plain version's do.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops import collectives
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build
from text_segmentation_image_inpainting_tpu_torch.utils.profiling import count

BN_LAUNCHES = 0

# the activations applied inside the kernels, by the name the models use
FUSED_ACTS = {
    "none": lambda x: x,
    "relu": F.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "leaky": lambda x: F.leaky_relu(x, 0.2),
}
_ACT_CODE = {"none": 0, "relu": 1, "relu6": 2, "leaky": 3}

# the running statistics' update, r = KEEP * r + MOMENTUM * batch
MOMENTUM, KEEP = 0.1, 0.9

# the geometry, as csrc/batchnorm.cu has it (tests/test_torch_batchnorm.py
# holds the two against each other)
BN_THREADS = 512  # BN_THREADS: the most threads of a CTA
# the plan's aims: CTAs per SM (two waves), the most bytes the
# fold of one channel block reads, and the fewest channel vectors of a
# block where C is wide enough (128 bytes of a row in bf16)
BN_WAVES = 2
BN_FOLD_BYTES = 64 * 1024
BN_MIN_CV = 8
BN_VEC_BYTES = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BNPlan(NamedTuple):
    """How the kernels cut (rows, C): channel vectors of ``vec`` elements
    (16 bytes, or 1 where C is not a multiple), CTAs of ``lanes`` x
    ``cvb`` threads over ``cvb`` channel vectors and an equal share of the
    rows, a grid of ``row_blocks`` x ``cblocks``."""

    vec: int
    cvb: int
    cblocks: int
    lanes: int
    row_blocks: int

    @property
    def threads(self) -> int:
        return self.lanes * self.cvb

    @property
    def ctas(self) -> int:
        return self.row_blocks * self.cblocks

    def part_floats(self, c: int) -> int:
        """The CTAs' partial sums: 2 x row blocks x C floats."""
        return 2 * self.row_blocks * c

    def fold_bytes(self) -> int:
        """What the last CTA of a channel block reads to fold the partials."""
        return 2 * 4 * self.row_blocks * self.cvb * self.vec

    def smem_bytes(self) -> int:
        """The reducing kernels' dynamic shared memory: 2 x threads x vec floats."""
        return 2 * 4 * self.threads * self.vec


def _cut(rows: int, cv: int, cblocks: int, vec: int, sms: int) -> BNPlan:
    cvb = _cdiv(cv, cblocks)
    cblocks = _cdiv(cv, cvb)
    row_blocks = min(rows, max(1, BN_WAVES * sms // cblocks))
    lanes = max(1, min(BN_THREADS // cvb, rows // row_blocks))
    return BNPlan(vec, cvb, cblocks, lanes, row_blocks)


@functools.lru_cache(maxsize=None)
def bn_plan(rows: int, c: int, elem: int, sms: int) -> BNPlan:
    """The cut of (rows, C) in ``elem``-byte elements on ``sms`` SMs:
    ``BN_WAVES`` CTAs an SM (each CTA an equal share of the rows and one
    channel block), fewer only where there are fewer rows, channel blocks
    narrowed from the whole of C until the fold of one reads at most
    ``BN_FOLD_BYTES`` or a block is down to ``BN_MIN_CV`` vectors, and at
    most ``BN_THREADS`` threads a CTA."""
    if rows < 1 or c < 1:
        raise ValueError(f"BatchNorm needs rows and channels, got ({rows}, {c})")
    vec = BN_VEC_BYTES // elem if c % (BN_VEC_BYTES // elem) == 0 else 1
    cv = c // vec
    cblocks = _cdiv(cv, BN_THREADS)
    plan = _cut(rows, cv, cblocks, vec, sms)
    while plan.fold_bytes() > BN_FOLD_BYTES and plan.cvb > BN_MIN_CV:
        cblocks += 1
        plan = _cut(rows, cv, cblocks, vec, sms)
    return plan


def batchnorm_plain(x: torch.Tensor, weight, bias, running_mean, running_var,
                    num_batches_tracked, *, batch_stats: bool, eps: float,
                    act: str = "none") -> torch.Tensor:
    """The eager chain in flax's arithmetic, then ``FUSED_ACTS[act]``: x
    promoted to at least f32 (f64 stays f64); with ``batch_stats`` the
    batch's mean and var = max(E[x^2] - E[x]^2, 0) over all but the last
    dim (the global batch's under ``data_parallel``), the running
    statistics moved with the biased variance; else the running
    statistics; the affine in that precision; cast back to x's dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if batch_stats:
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        mean2 = (xf * xf).mean(dim=dims)
        if collectives.active() is not None:
            both = collectives.all_reduce_stats(torch.cat([mean, mean2]))
            both = both / collectives.dp_world()
            mean, mean2 = both[:mean.shape[0]], both[mean.shape[0]:]
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            running_mean.mul_(KEEP).add_(MOMENTUM * mean)
            running_var.mul_(KEEP).add_(MOMENTUM * var)
            num_batches_tracked.add_(1)
    else:
        mean, var = running_mean, running_var
    y = xf - mean
    y = y * (torch.rsqrt(var + eps) * weight)
    y = y + bias
    return FUSED_ACTS[act](y.to(x.dtype))


def batchnorm(x: torch.Tensor, weight, bias, running_mean, running_var, num_batches_tracked, *,
              batch_stats: bool, eps: float, act: str = "none") -> torch.Tensor:
    """BatchNorm over all but the last dim of ``x`` and ``FUSED_ACTS[act]``
    after it: the kernels for a CUDA bf16 or f32 ``x`` (f32 parameters and
    statistics), ``batchnorm_plain`` otherwise (see the module's note)."""
    if act not in FUSED_ACTS:
        raise ValueError(f"unknown activation {act!r}; fused: {sorted(FUSED_ACTS)}")
    if not x.is_cuda or (x.dtype is not torch.bfloat16 and x.dtype is not torch.float32):
        count("bn.plain")
        return batchnorm_plain(x, weight, bias, running_mean, running_var, num_batches_tracked,
                               batch_stats=batch_stats, eps=eps, act=act)
    count("bn.kernel")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _BatchNormFn.apply(x, weight, bias, running_mean, running_var,
                                  num_batches_tracked, batch_stats, act, eps)
    return _forward(x, weight, bias, running_mean, running_var, num_batches_tracked,
                    batch_stats, act, eps, save=False)[0]


# Per (device, stream): the tickets of the reducing kernels (zero between
# launches; each launch's last CTAs reset theirs), so launches on one
# stream run in order and launches on two streams never share them.
_TICKETS: dict = {}
_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        _LIB = build.load_library()
    return _LIB


def _stream(device: int) -> int:
    """The current CUDA stream of device ``device``, as a pointer."""
    return torch._C._cuda_getCurrentRawStream(device)


def _tickets(device: int, stream: int, cblocks: int) -> torch.Tensor:
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < cblocks:
        t = _TICKETS[key] = torch.zeros(max(cblocks, 256), dtype=torch.int32,
                                        device=torch.device("cuda", device))
    return t


@functools.lru_cache(maxsize=None)
def _geometry(rows: int, c: int, is_bf16: bool, device: int) -> tuple:
    """(``bn_plan``'s plan, the launchers' geometry arguments) of (rows, C)
    on CUDA device ``device``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = bn_plan(rows, c, 2 if is_bf16 else 4, sms)
    return plan, (rows, c, int(is_bf16), plan.vec, plan.cvb, plan.lanes, plan.row_blocks,
                  plan.cblocks)


def _check_operands(c: int, device: int, *tensors) -> None:
    for t in tensors:
        if t.dtype is not torch.float32 or t.numel() != c or t.get_device() != device:
            raise ValueError(f"the BatchNorm kernels take f32 parameters and statistics of "
                             f"shape ({c},) on cuda:{device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def _forward(x, weight, bias, running_mean, running_var, num_batches_tracked, batch_stats, act,
             eps, save):
    """bn_stats (with ``batch_stats``) and bn_apply: (y, the vectors the
    backward keeps (4 x C: mean, rstd, scale, not clamped) or None, x as
    the kernels read it)."""
    global BN_LAUNCHES
    c, dev = x.shape[-1], x.get_device()
    _check_operands(c, dev, weight, bias, running_mean, running_var)
    x = x.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return y, None, x
    plan, geo = _geometry(rows, c, x.dtype is torch.bfloat16, dev)
    lib, stream = _library(), _stream(dev)
    saved = stats = None
    world = 1
    if save or batch_stats:
        vecs = torch.empty((4 if save else 0) + (2 if batch_stats else 0), c,
                           dtype=torch.float32, device=x.device)
        saved = vecs[:4].view(-1) if save else None
    if batch_stats:
        stats = vecs[-2:].view(-1)
        part = torch.empty(plan.part_floats(c), dtype=torch.float32, device=x.device)
        tickets = _tickets(dev, stream, plan.cblocks)
        code = lib.tsii_bn_stats(x.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                                 stats.data_ptr(), *geo, stream)
        if code:
            build.check(lib, code, "bn_stats")
        BN_LAUNCHES += 1
        dp = collectives.active()
        if dp is not None:
            stats, world = collectives.all_reduce_stats(stats), dp.size
    code = lib.tsii_bn_apply(
        x.data_ptr(), y.data_ptr(), stats.data_ptr() if batch_stats else None,
        running_mean.data_ptr(), running_var.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        saved.data_ptr() if save else None,
        num_batches_tracked.data_ptr() if batch_stats else None, *geo, _ACT_CODE[act], eps,
        MOMENTUM, KEEP, float(world), stream)
    if code:
        build.check(lib, code, "bn_apply")
    BN_LAUNCHES += 1
    return y, saved, x


class _BatchNormFn(torch.autograd.Function):
    """The kernels' forward and backward (2 + 2 launches with the batch's
    statistics, 1 + 1 or 2 on the running ones)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked,
                batch_stats, act, eps):
        y, saved, xc = _forward(x, weight, bias, running_mean, running_var, num_batches_tracked,
                                batch_stats, act, eps, save=True)
        ctx.save_for_backward(xc, saved, bias)
        ctx.batch_stats, ctx.act, ctx.dp = batch_stats, act, collectives.active()
        return y

    @staticmethod
    def backward(ctx, dy):
        global BN_LAUNCHES
        x, saved, bias = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        if saved is None:  # no rows
            return (torch.zeros_like(x) if need_x else None,
                    torch.zeros_like(bias) if need_w else None,
                    torch.zeros_like(bias) if need_b else None) + (None,) * 6
        c, dev = x.shape[-1], x.get_device()
        rows = x.numel() // c
        dy = dy.contiguous()
        plan, geo = _geometry(rows, c, x.dtype is torch.bfloat16, dev)
        lib, stream = _library(), _stream(dev)
        act = _ACT_CODE[ctx.act]
        red = None
        if need_w or need_b or (need_x and ctx.batch_stats):
            red = torch.empty(2, c, dtype=torch.float32, device=x.device)
            part = torch.empty(plan.part_floats(c), dtype=torch.float32, device=x.device)
            tickets = _tickets(dev, stream, plan.cblocks)
            code = lib.tsii_bn_bwd_reduce(dy.data_ptr(), x.data_ptr(), saved.data_ptr(),
                                          bias.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                                          red.data_ptr(), *geo, act, stream)
            if code:
                build.check(lib, code, "bn_bwd_reduce")
            BN_LAUNCHES += 1
        dx = None
        if need_x:
            sums, world = None, 1
            if ctx.batch_stats:
                sums = red
                if ctx.dp is not None:
                    # autograd runs this on its own thread, outside the caller's scope
                    with collectives.data_parallel(ctx.dp.group, ctx.dp.size):
                        sums = collectives.all_reduce_stats(red)
                    world = ctx.dp.size
            dx = torch.empty_like(x)
            code = lib.tsii_bn_bwd_dx(dy.data_ptr(), x.data_ptr(), saved.data_ptr(),
                                      bias.data_ptr(), None if sums is None else sums.data_ptr(),
                                      dx.data_ptr(), *geo, act, 1.0 / (rows * world), stream)
            if code:
                build.check(lib, code, "bn_bwd_dx")
            BN_LAUNCHES += 1
        return (dx, red[1] if need_w else None, red[0] if need_b else None) + (None,) * 6
