"""Train state and optimizer assembly on ``torch.optim``.

Counterpart of ``text_segmentation_image_inpainting_tpu/train/state.py``.
Parameters and optimizer state are f32; the model computes in its own
dtype. ``make_optimizer`` maps each ``OptimizerConfig`` branch of the JAX
package's optax chain onto ``torch.optim``:

  adam                    -> Adam
  adam + weight_decay     -> AdamW (decoupled decay, as optax.adamw)
  amsgrad [+ decay]       -> Adam / AdamW(amsgrad=True)
  sgd [+ momentum, decay] -> SGD (decay folded into the gradient, as
                             optax.add_decayed_weights before sgd)

and the learning-rate schedule (linear warmup, SGDR cosine restarts)
onto a ``LambdaLR`` of ``learning_rate_at``. Where the two libraries
differ, the port keeps torch's rule; ``tests/test_torch_train_state.py``
pins each difference:

  * optax schedules read the update count BEFORE the update, so the
    first warmup step has lr 0; ``LambdaLR`` starts at count 0 too, and
    ``TrainState.apply_gradients`` steps it after the update: the same.
  * amsgrad: optax keeps the running max of the bias-CORRECTED second
    moment; torch keeps the max of the raw moment and divides it by the
    current step's bias correction. They agree while the corrected
    moment does not fall (e.g. gradients of constant magnitude) and
    differ after a gradient shrinks: torch then takes the larger step.
  * global-norm clipping: ``clip_grad_norm_`` scales by
    max_norm / (norm + 1e-6) where optax scales by max_norm / norm
    (a relative difference of 1e-6 / norm).

``create_train_state(capturable=True)`` builds a state whose update a
CUDA graph can capture (``train/multistep.py``): Adam with
``capturable=True`` and a 0-d f32 learning-rate tensor on the device,
which ``apply_gradients`` rewrites in place from a device update count
(``learning_rate_tensor``) in place of ``LambdaLR``'s Python float; the
clip's coefficient stays on the device as well. Adam's capturable update
computes its bias corrections on the device, so it agrees with the
default one to rounding, not bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterable, Set

import torch
import torch.nn as nn

from text_segmentation_image_inpainting_tpu_torch.train.config import OptimizerConfig


def learning_rate_at(cfg: OptimizerConfig, count: int) -> float:
    """The schedule's learning rate for the update after ``count`` updates
    (optax's ``linear_schedule`` / ``sgdr_schedule`` of
    ``warmup_cosine_decay_schedule`` cycles, as ``make_optimizer`` builds it)."""
    lr = cfg.learning_rate
    if cfg.restart_period > 0:
        period, warm = cfg.restart_period, cfg.warmup_steps
        cycle = min(count // period, cfg.restart_cycles - 1)
        c = count - cycle * period
        init = 0.0 if warm else lr
        if c < warm:
            return init + (lr - init) * c / warm
        decay = period - warm
        c = min(c - warm, decay)
        alpha = 0.01  # end value lr * 0.01
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)
    if cfg.warmup_steps > 0:
        return lr * min(count, cfg.warmup_steps) / cfg.warmup_steps
    return lr


def learning_rate_tensor(cfg: OptimizerConfig, count: torch.Tensor) -> torch.Tensor:
    """``learning_rate_at`` of a 0-d f64 tensor ``count``, computed on its
    device (no host round trip, so a captured graph follows the schedule)."""
    lr = cfg.learning_rate
    if cfg.restart_period > 0:
        period, warm = cfg.restart_period, cfg.warmup_steps
        cycle = torch.clamp(torch.floor(count / period), max=cfg.restart_cycles - 1)
        c = count - cycle * period
        init = 0.0 if warm else lr
        rise = init + (lr - init) * c / max(warm, 1)
        decay = period - warm
        cc = torch.clamp(c - warm, max=decay)
        alpha = 0.01
        fall = lr * ((1 - alpha) * 0.5 * (1 + torch.cos(math.pi * cc / decay)) + alpha)
        return torch.where(c < warm, rise, fall)
    if cfg.warmup_steps > 0:
        return lr * torch.clamp(count, max=cfg.warmup_steps) / cfg.warmup_steps
    return torch.full_like(count, lr)


def make_optimizer(cfg: OptimizerConfig, params: Iterable[torch.Tensor], *,
                   capturable: bool = False):
    """(optimizer, scheduler or None) for ``params``. ``capturable``:
    Adam/AdamW with ``capturable=True`` and a 0-d learning-rate tensor on
    the parameters' device, no scheduler (``TrainState`` moves the lr)."""
    params = list(params)
    lr = cfg.learning_rate
    if capturable:
        if cfg.kind != "adam":
            raise ValueError(f"a capturable train state needs kind='adam', got {cfg.kind!r} "
                             "(torch's SGD reads a tensor learning rate on the host)")
        lr_t = torch.full((), learning_rate_at(cfg, 0), dtype=torch.float32,
                          device=params[0].device)
        cls = torch.optim.AdamW if cfg.weight_decay else torch.optim.Adam
        kw = dict(weight_decay=cfg.weight_decay) if cfg.weight_decay else {}
        return cls(params, lr=lr_t, betas=(cfg.beta1, cfg.beta2), eps=1e-8, amsgrad=cfg.amsgrad,
                   capturable=True, **kw), None
    if cfg.kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=cfg.beta1 or 0.0,
                              weight_decay=cfg.weight_decay)
    elif cfg.kind != "adam":
        raise ValueError(f"unknown optimizer kind {cfg.kind!r} (adam|sgd)")
    elif cfg.weight_decay:
        opt = torch.optim.AdamW(params, lr=lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                                weight_decay=cfg.weight_decay, amsgrad=cfg.amsgrad)
    else:
        opt = torch.optim.Adam(params, lr=lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                               amsgrad=cfg.amsgrad)
    sched = None
    if cfg.restart_period > 0 or cfg.warmup_steps > 0:
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: learning_rate_at(cfg, count) / lr
        )
    return opt, sched


@dataclasses.dataclass
class TrainState:
    """A model, its optimizer and schedule, and the count of updates.

    ``clip_params`` are all parameters the global-norm clip sees, frozen
    ones included (optax clips before its frozen mask); the optimizer
    holds only the trainable ones. A capturable state (``cfg`` set) keeps
    its learning rate ``lr`` and update count ``count`` as 0-d tensors on
    the device; ``step`` stays the host's count.
    """

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None
    grad_clip_norm: float | None
    clip_params: list
    step: int = 0
    cfg: OptimizerConfig | None = None
    lr: torch.Tensor | None = None
    count: torch.Tensor | None = None

    @property
    def capturable(self) -> bool:
        return self.lr is not None

    def apply_gradients(self) -> None:
        """Clip, update, advance the schedule, clear the gradients (of
        frozen parameters too, which the optimizer does not hold: the next
        step's clip and ``grad_norm`` must not see them accumulate)."""
        if self.grad_clip_norm:
            grads = [p for p in self.clip_params if p.grad is not None]
            torch.nn.utils.clip_grad_norm_(grads, self.grad_clip_norm)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        if self.capturable:
            self.count.add_(1)
            self.lr.copy_(learning_rate_tensor(self.cfg, self.count))
        for p in self.clip_params:
            p.grad = None
        self.step += 1

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
        if self.capturable:
            # the groups' lr is this state's device tensor, at the schedule's count
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr
            self.count.fill_(self.step)
            self.lr.copy_(learning_rate_tensor(self.cfg, self.count))
        elif self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])


def data_parallel(mesh):
    """The scope of one step over ``mesh``: a rank mesh's
    ``data_parallel()``, nothing without a mesh or for a device mesh."""
    return contextlib.nullcontext() if mesh is None else mesh.data_parallel()


def freeze_mask_for(model: nn.Module, *prefixes: str) -> Set[str]:
    """Names of the parameters under any top-level prefix (e.g. 'encoder'),
    for ``create_train_state(frozen=...)``."""
    return {name for name, _ in model.named_parameters()
            if any(name.split(".")[0].startswith(p) for p in prefixes)}


def create_train_state(model: nn.Module, cfg: OptimizerConfig, *,
                       frozen: Set[str] = frozenset(), capturable: bool = False) -> TrainState:
    """A TrainState whose optimizer updates every parameter not named in
    ``frozen``; ``capturable`` for a step captured in a CUDA graph."""
    named = list(model.named_parameters())
    opt, sched = make_optimizer(cfg, [p for n, p in named if n not in frozen],
                                capturable=capturable)
    state = TrainState(model, opt, sched, cfg.grad_clip_norm, [p for _, p in named])
    if capturable:
        state.cfg, state.lr = cfg, opt.param_groups[0]["lr"]
        state.count = torch.zeros((), dtype=torch.float64, device=state.lr.device)
    return state
