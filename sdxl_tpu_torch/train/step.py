"""The train step: AdamW with a cosine schedule, gradient accumulation and
EMA (counterpart of sdxl_tpu/train/step.py, which builds on optax).

``adamw_cosine`` keeps optax's semantics exactly, the reference's
``chain(clip_by_global_norm(c), adamw(schedule, b1, b2, weight_decay))``:
- clip: g * c / ||g|| when the global norm ||g|| >= c (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``);
- Adam: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, both bias-
  corrected in f32 with the incremented count, update mu_hat / (sqrt(nu_hat) +
  1e-8), plus weight_decay * params (decoupled), times -lr(count) with the
  count read before its increment;
- the schedules are optax's cosine_decay_schedule and
  warmup_cosine_decay_schedule in closed form.
The state is functional, as in the reference: each step returns new
tensors and leaves the old ones alone.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
_EPS = 1e-8  # optax's adam eps


@dataclass
class TrainState:
    params: Params            # trainable leaves (e.g. flat LoRA factors)
    opt_state: dict
    ema: Optional[Params]     # EMA shadow of params (None if disabled)
    step: int

    @classmethod
    def create(cls, params: Params, tx: "AdamWCosine",
               ema: bool = False) -> "TrainState":
        params = {k: v.detach().float() for k, v in params.items()}
        return cls(params=params, opt_state=tx.init(params),
                   ema={k: v.clone() for k, v in params.items()}
                   if ema else None,
                   step=0)


@dataclass(frozen=True)
class AdamWCosine:
    """Global-norm clipping then AdamW over a cosine learning rate."""

    lr: float
    steps: int
    warmup: int = 0
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: Optional[float] = 1.0
    final_lr_frac: float = 0.0

    def schedule(self, count: int) -> float:
        """The learning rate at step ``count`` (0-based)."""
        if self.warmup > 0:
            if count < self.warmup:
                frac = 1.0 - count / self.warmup
                return (0.0 - self.lr) * frac + self.lr
            decay = max(self.steps, self.warmup + 1) - self.warmup
            return _cosine(self.lr, decay, self.final_lr_frac,
                           count - self.warmup)
        return _cosine(self.lr, max(self.steps, 1), self.final_lr_frac, count)

    def init(self, params: Params) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params):
        """(updates, new state); params + updates are the new params."""
        if self.grad_clip is not None:
            norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                  for g in grads.values()))
            scale = torch.where(norm < self.grad_clip,
                                torch.ones_like(norm), self.grad_clip / norm)
            grads = {k: g * scale for k, g in grads.items()}
        count = state["count"]
        n = count + 1
        # bias corrections in f32, as optax computes them
        c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(n))
                  for b in (self.b1, self.b2))
        lr = self.schedule(count)
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1.0 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1.0 - self.b2) * g * g + self.b2 * state["nu"][k]
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + _EPS)
            updates[k] = (u + self.weight_decay * params[k]) * -lr
        return updates, {"count": n, "mu": mu, "nu": nu}


def _cosine(init: float, decay_steps: int, alpha: float, count: int) -> float:
    count = min(count, decay_steps)
    cos = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    return init * ((1.0 - alpha) * cos + alpha)


def adamw_cosine(lr: float, steps: int, warmup: int = 0,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, grad_clip: Optional[float] = 1.0,
                 final_lr_frac: float = 0.0) -> AdamWCosine:
    """The diffusion fine-tune recipe: AdamW with linear warmup and cosine
    decay, global-norm gradient clipping."""
    return AdamWCosine(lr, steps, warmup, weight_decay, b1, b2, grad_clip,
                       final_lr_frac)


def value_and_grad(loss_fn: Callable, params: Params, batch: dict, draw):
    """(loss, {name: d loss / d param}) of loss_fn(params, batch, draw)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves, batch, draw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_train_step(loss_fn: Callable, tx: AdamWCosine,
                    ema_decay: Optional[float] = None, accum: int = 1):
    """step(state, batch, draws) -> (state, loss).

    loss_fn(trainable, batch, draw) -> scalar loss. With accum > 1 every
    batch entry carries a leading microbatch axis [accum, per_micro, ...]
    and ``draws`` holds one draw per microbatch (or one generator drawn
    from in turn); losses and grads are averaged over the microbatches in
    f32 before the single update (for a mean-reduced loss, the update of
    one big batch)."""

    def step(state: TrainState, batch: dict, draws):
        if accum == 1:
            loss, grads = value_and_grad(loss_fn, state.params, batch, draws)
        else:
            if not isinstance(draws, Sequence):
                draws = [draws] * accum
            loss = torch.zeros((), device=next(iter(state.params.values()))
                               .device)
            grads = {k: torch.zeros_like(v) for k, v in state.params.items()}
            for i in range(accum):
                mbatch = {k: v[i] for k, v in batch.items()}
                loss_i, g_i = value_and_grad(loss_fn, state.params, mbatch,
                                             draws[i])
                loss = loss + loss_i
                grads = {k: grads[k] + g_i[k].float() for k in grads}
            loss = loss / accum
            grads = {k: g / accum for k, g in grads.items()}
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = {k: (p + updates[k]).to(p.dtype)
                  for k, p in state.params.items()}
        ema = state.ema
        if ema is not None:
            d = ema_decay if ema_decay is not None else 0.999
            ema = {k: d * e + (1.0 - d) * params[k].to(e.dtype)
                   for k, e in ema.items()}
        return TrainState(params=params, opt_state=opt_state, ema=ema,
                          step=state.step + 1), loss

    return step
