"""Optimizers and the learning-rate schedule.

Counterpart of ``openseg3d_tpu/models/optim.py``:
  * ``sgd`` is ``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))``,
    which is ``torch.optim.SGD(momentum, weight_decay=wd, dampening=0,
    nesterov=False)``: the decay joins the gradient before the momentum
    trace, and the first trace is the gradient itself in both;
  * ``adamw`` is ``optax.adamw(lr, weight_decay=wd)``, which is
    ``torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)``.
Both decay every parameter, BatchNorm and LayerNorm scales and biases
included, because the JAX package passes optax no mask.

The schedule is a function of the update count: update i (counted from 0)
uses ``schedule(i)``, which the train step writes into the optimizer's
parameter group before it steps (``set_learning_rate``). The schedules are
warmup-poly (the recipe's), cosine annealing (``optax.cosine_decay_schedule``)
and one-cycle (``optax.cosine_onecycle_schedule`` at optax's defaults), in
float64 on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def warmup_poly_schedule(base_lr: float, max_iters: int, warmup_iters: int,
                         warmup_factor: float = 0.001, power: float = 0.9):
    """lr(i) = base * warmup(i) * (1 - i / max_iters) ** power with a linear
    warmup from warmup_factor over warmup_iters updates."""
    def schedule(count: int) -> float:
        i = min(count, max_iters)
        alpha = min(i / max(warmup_iters, 1), 1.0)
        warm = warmup_factor * (1 - alpha) + alpha
        poly = max(1.0 - i / max_iters, 0.0) ** power
        return base_lr * warm * poly
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int):
    """``optax.cosine_decay_schedule(init_value, decay_steps)``: init_value x
    (1 + cos(pi min(i, decay_steps) / decay_steps)) / 2."""
    def schedule(count: int) -> float:
        i = min(count, decay_steps)
        return init_value * 0.5 * (1 + math.cos(math.pi * i / decay_steps))
    return schedule


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4):
    """``optax.cosine_onecycle_schedule``: a cosine rise from peak /
    div_factor to peak over the first int(pct_start x transition_steps)
    updates, a cosine fall to peak / (div_factor x final_div_factor) by
    transition_steps, flat after (optax's piecewise cosine interpolation)."""
    bounds = np.array([0, int(pct_start * transition_steps), int(transition_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def schedule(count: int) -> float:
        for k in range(2):
            if bounds[k] <= count < bounds[k + 1]:
                pct = (count - bounds[k]) / (bounds[k + 1] - bounds[k])
                start, end = values[k], values[k + 1]
                return float(end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1))
        return float(values[-1]) if count >= bounds[-1] else 0.0
    return schedule


def build_schedule(cfg, epochs: int, iters_per_epoch: int):
    total = max(epochs * iters_per_epoch, 1)
    name = cfg.TRAIN.LR_SCHEDULER
    lr = cfg.TRAIN.LR
    if name == 'warmup_poly_lr':
        return warmup_poly_schedule(lr, total, warmup_iters=iters_per_epoch)
    if name == 'cosine_annealing':
        return cosine_decay_schedule(lr, total)
    if name == 'one_cycle':
        return cosine_onecycle_schedule(total, lr)
    raise NotImplementedError(name)


def build_optimizer(cfg, params) -> torch.optim.Optimizer:
    """The optimizer over `params` (one group: every parameter decays). Its
    learning rate is set per update by the train step."""
    params = list(params)
    lr, wd = float(cfg.TRAIN.LR), float(cfg.TRAIN.WEIGHT_DECAY)
    if cfg.TRAIN.OPTIMIZER == 'adamw':
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=wd)
    if cfg.TRAIN.OPTIMIZER == 'sgd':
        return torch.optim.SGD(params, lr=lr, momentum=float(cfg.TRAIN.MOMENTUM),
                               dampening=0.0, weight_decay=wd, nesterov=False)
    raise NotImplementedError(cfg.TRAIN.OPTIMIZER)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group['lr'] = lr
