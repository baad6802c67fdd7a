"""Optimisers and learning-rate schedules with the reference's semantics.

Counterpart of ``pointvs_tpu/training/optimisers.py``. The update applied
to the gradients of the mean loss is, in order:

1. clip each gradient element to [-1, 1] (``clip_grad_value_``);
2. add the coupled L2 weight decay ``wd * param`` (not AdamW);
3. Adam (betas 0.9 / 0.999, eps 1e-8 outside the square root) or SGD
   with Nesterov momentum 0.9.

``torch.optim.Adam`` / ``SGD`` with ``weight_decay`` apply steps 2-3
exactly so, after ``step`` has done step 1. The learning rate comes from a
host-side schedule (step -> lr) and is set on the optimiser before every
step, as the reference passes it into its train step.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def build_optimiser(params, optimiser: str = 'adam',
                    weight_decay: Optional[float] = 1e-4,
                    lr: float = 1e-3) -> torch.optim.Optimizer:
    weight_decay = weight_decay or 0.0
    if optimiser == 'adam':
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if optimiser == 'sgd':
        return torch.optim.SGD(params, lr=lr, momentum=0.9, nesterov=True,
                               weight_decay=weight_decay)
    raise NotImplementedError(f'{optimiser} not recognised optimiser.')


def clip_and_step(optimiser: torch.optim.Optimizer, lr: float) -> None:
    """Clip every gradient by value at 1.0, then one step at ``lr``.

    A parameter the loss did not reach (the multitask model's other head,
    a last layer's coordinate MLP) steps on a zero gradient, as every
    parameter does in the reference's optax chain: the weight decay and
    the moments still move it. torch's optimisers would skip it.
    """
    params = [p for group in optimiser.param_groups for p in group['params']]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    torch.nn.utils.clip_grad_value_(params, 1.0)
    for group in optimiser.param_groups:
        group['lr'] = lr
    optimiser.step()


def onecycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.3,
                div_factor: float = 25.0, final_div_factor: float = 1e4
                ) -> Callable[[int], float]:
    """torch OneCycleLR (anneal_strategy='cos') as a step -> lr function."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up_steps = max(1, int(pct_start * total_steps) - 1)
    down_steps = max(1, total_steps - up_steps - 1)

    def schedule(step: int) -> float:
        step = min(step, total_steps - 1)
        if step <= up_steps:
            frac = step / up_steps
            return initial + (max_lr - initial) * 0.5 * (
                1 - math.cos(math.pi * frac))
        frac = (step - up_steps) / down_steps
        return final + (max_lr - final) * 0.5 * (
            1 + math.cos(math.pi * frac))

    return schedule


def cosine_warm_restarts_lr(base_lr: float, t_0: int, eta_min: float = 0.0
                            ) -> Callable[[int], float]:
    """torch CosineAnnealingWarmRestarts with T_mult=1."""
    t_0 = max(1, t_0)

    def schedule(step: int) -> float:
        t_cur = step % t_0
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * t_cur / t_0))

    return schedule


def constant_lr(lr: float) -> Callable[[int], float]:
    return lambda step: lr


def make_lr_schedule(lr: float, steps_per_epoch: int, epochs: int,
                     use_1cycle: bool = False, warm_restarts: bool = False
                     ) -> Callable[[int], float]:
    if use_1cycle and warm_restarts:
        raise ValueError('1cycle and warm restarts are mutually exclusive')
    if use_1cycle:
        return onecycle_lr(lr, max(1, epochs * steps_per_epoch))
    if warm_restarts:
        return cosine_warm_restarts_lr(lr, steps_per_epoch)
    return constant_lr(lr)
