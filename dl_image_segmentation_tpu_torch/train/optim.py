"""The trainer's optimizer, to optax's arithmetic: learning-rate schedules,
``clip_by_global_norm`` and AdamW.

The JAX package trains with ``optax.adamw(schedule, weight_decay=wd)``,
optionally behind ``optax.clip_by_global_norm`` (``train/trainer.py``);
this module does the same operations in the same order with
``torch._foreach`` ops (one multi-tensor kernel per operation on the
card, the same code on the CPU):

* schedules are functions of the update count ``t`` (from 0) that equal
  ``optax.linear_schedule`` and ``optax.warmup_cosine_decay_schedule``
  (end value 0), evaluated in float32 on the host, so the step needs no
  device sync for its learning rate;
* clipping leaves the gradients alone when the global norm is below
  ``max_norm``, else scales each to ``g / norm * max_norm``;
* AdamW (b1 0.9, b2 0.999, eps 1e-8, eps_root 0): ``mu = (1 - b1) g +
  b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, ``u = (mu / (1 - b1^t)) /
  (sqrt(nu / (1 - b2^t)) + eps) + wd p`` and ``p = p + (-lr) u``, with
  weight decay on every parameter (optax's mask is None), scaled by
  the learning rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update_", "clip_by_global_norm_",
           "linear_schedule", "make_schedule",
           "warmup_cosine_decay_schedule"]

B1, B2, EPS = 0.9, 0.999, 1e-8
_F = np.float32


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init_value to end_value over
    ``transition_steps`` updates, then held."""
    if transition_steps <= 0:
        return lambda count: float(_F(init_value))

    def schedule(count: int) -> float:
        c = _F(min(max(count, 0), transition_steps))
        frac = _F(1) - c / _F(transition_steps)
        return float(_F(init_value - end_value) * frac + _F(end_value))
    return schedule


def _cosine_decay(init_value: float, decay_steps: int
                  ) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        c = _F(min(count, decay_steps))
        cos = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * c / _F(decay_steps)))
        return float(_F(init_value) * cos)
    return schedule


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int,
                                 decay_steps: int
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak_value, warmup_steps,
    decay_steps), end value 0: linear warmup from 0, then cosine decay
    to 0 at ``decay_steps`` (which counts the warmup)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")
    warm = linear_schedule(0.0, peak_value, warmup_steps)
    decay = _cosine_decay(peak_value, decay_steps - warmup_steps)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def make_schedule(config) -> Callable[[int], float]:
    """The learning rate at update ``t`` for a TrainConfig, as the JAX
    Trainer builds it: cosine (warmup >= 1, horizon >= 2), linear warmup,
    or constant."""
    lr = config.learning_rate
    if config.schedule == "cosine":
        return warmup_cosine_decay_schedule(
            lr, max(config.warmup_steps, 1), max(config.total_steps, 2))
    if config.warmup_steps > 0:
        return linear_schedule(0.0, lr, config.warmup_steps)
    return lambda count: float(_F(lr))


@dataclasses.dataclass
class AdamWState:
    """optax's ScaleByAdamState: the update count and the first and
    second moments, by parameter name."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adamw_init(params: Dict[str, torch.Tensor]) -> AdamWState:
    return AdamWState(0, {n: torch.zeros_like(p) for n, p in params.items()},
                      {n: torch.zeros_like(p) for n, p in params.items()})


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         groups: Optional[List] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place; returns the global norm (a
    device scalar: no sync). Below ``max_norm`` each gradient is divided
    by 1 and multiplied by 1, which leaves it as it was. ``groups``, one
    per gradient, names the process group over which a sharded
    gradient's shards add up to the whole (None: replicated): the sum of
    squares of each is all-reduced over its group, so every shard counts
    once and a replicated gradient once."""
    norms = torch._foreach_norm(grads)
    if groups is None or all(g is None for g in groups):
        g_norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        from ..parallel.spmd import all_reduce
        by_group: dict = {}
        for n, g in zip(norms, groups):
            by_group.setdefault(g, []).append(n)
        total = None
        for g, ns in by_group.items():
            sq = all_reduce(torch.stack(ns).square().sum(), g)
            total = sq if total is None else total + sq
        g_norm = torch.sqrt(total)
    keep = g_norm < max_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return g_norm


@torch.no_grad()
def adamw_update_(params: List[torch.Tensor], grads: List[torch.Tensor],
                  mu: List[torch.Tensor], nu: List[torch.Tensor],
                  count: int, lr: float, weight_decay: float) -> int:
    """One optax AdamW update of ``params`` in place (``mu`` and ``nu``
    too); ``count`` is the state's count before the update. Returns the
    new count."""
    count += 1
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - B1))
    torch._foreach_mul_(nu, B2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - B2))
    # optax's bias corrections, in float32
    bc1 = float(_F(1) - _F(B1) ** _F(count))
    bc2 = float(_F(1) - _F(B2) ** _F(count))
    u = torch._foreach_div(mu, bc1)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, EPS)
    torch._foreach_div_(u, den)
    if weight_decay:
        torch._foreach_add_(u, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(u, -lr)
    torch._foreach_add_(params, u)
    return count
