"""Plain PyTorch training steps of PointVS: which graphs each step takes,
the learning rate, the loss and its gradient, and the optimiser update.

- The index stream (a frozen copy of PointVS's sampling): a pose set with
  both classes is drawn with replacement in proportion to each graph's
  inverse class frequency, ``RandomState(seed).choice(n, n, p=...)``;
  otherwise the indices are shuffled, ``RandomState(seed).shuffle``. Each
  epoch takes the next draw of the same stream, and a step takes the next
  ``batch`` indices of its epoch.
- The learning rate is constant, or under warm restarts
  ``lr * (1 + cos(pi * t / T)) / 2`` with t the step within its epoch and
  T the steps of an epoch (cosine annealing restarted every epoch).
- The loss is the mean over the batch's graphs (``egnn.loss_sum``).
- The update: each gradient element clipped to [-1, 1], the coupled L2
  decay ``wd * p`` added, then Adam (betas 0.9 / 0.999, eps 1e-8 added to
  the square root of the bias-corrected second moment).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from pvsbench.reference import egnn

BETAS = (0.9, 0.999)
EPS = 1e-8


def epoch_indices(labels, seed: int, epochs: int, classification: bool):
    """The first ``epochs`` epochs' index arrays."""
    n = len(labels)
    rng = np.random.RandomState(seed)
    labels = np.asarray(labels)
    active = int((labels == 1).sum()) if classification else 0
    weighted = classification and active not in (0, n)
    out = []
    for _ in range(epochs):
        if weighted:
            w = 1.0 / np.array([n - active, active], np.float64)
            w = w[np.clip(labels.astype(np.int64), 0, 1)]
            out.append(rng.choice(n, size=n, replace=True, p=w / w.sum()))
        else:
            idx = np.arange(n)
            rng.shuffle(idx)
            out.append(idx)
    return out


def learning_rate(lr: float, step: int, steps_per_epoch: int,
                  warm_restarts: bool) -> float:
    if not warm_restarts:
        return lr
    t = step % max(1, steps_per_epoch)
    return lr * 0.5 * (1 + math.cos(math.pi * t / max(1, steps_per_epoch)))


def gradient(params: dict, graphs: list, y, task: str, layers: int,
             prec: egnn.Precision, device, edge_budget: int):
    """(mean loss, {name: gradient}) of one batch, in blocks of graphs."""
    for t in params.values():
        t.grad = None
    total = 0.0
    y = torch.as_tensor(np.asarray(y, np.float32))
    for lo, hi in egnn.blocks_of(graphs, edge_budget):
        b = egnn.block(graphs[lo:hi], device)
        with prec.active():
            loss = egnn.loss_sum(egnn.forward(params, b, layers, prec),
                                 y[lo:hi].to(device), task) / len(graphs)
        loss.backward()
        total += float(loss.detach())
    # A leaf the loss does not reach (the last layer's coordinate MLP)
    # has a zero gradient.
    return total, {k: (torch.zeros_like(t) if t.grad is None
                       else t.grad.detach().clone())
                   for k, t in params.items()}


def adam_update(params: dict, grads: dict, state: dict, step: int,
                lr: float, wd: float) -> dict:
    """One update in place; returns the gradients as the optimiser takes
    them (clipped, decay added)."""
    taken = {}
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k].clamp(-1.0, 1.0) + wd * p
            taken[k] = g
            m, v = state.setdefault(k, (torch.zeros_like(p),
                                        torch.zeros_like(p)))
            m.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
            v.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
            bc1 = 1 - BETAS[0] ** step
            bc2 = 1 - BETAS[1] ** step
            p.sub_(lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + EPS))
    return taken


def replay(weights: dict, batches: list, task: str, layers: int, lr: float,
           wd: float, steps_per_epoch: int, warm_restarts: bool,
           device, prec: egnn.Precision, edge_budget: int,
           moments: dict | None = None, first_step: int = 1):
    """``len(batches)`` steps from ``weights``, the first of them the
    ``first_step``-th of the run, with Adam's moments ``moments`` ({name:
    (first, second)}; none before the first step); each batch is (graphs,
    labels). -> (losses, the first step's gradients as the optimiser
    takes them, the first step's gradients of the loss, the parameters
    after the last step, the moments after it)."""
    params = {k: v.detach().clone().to(device).requires_grad_(True)
              for k, v in weights.items()}
    state = {k: (m.clone().to(device), v.clone().to(device))
             for k, (m, v) in (moments or {}).items()}
    losses, first, raw = [], None, None
    for step, (graphs, y) in enumerate(batches, start=first_step):
        loss, grads = gradient(params, graphs, y, task, layers, prec, device,
                               edge_budget)
        losses.append(loss)
        taken = adam_update(params, grads, state, step,
                            learning_rate(lr, step - 1, steps_per_epoch,
                                          warm_restarts), wd)
        if first is None:
            first = {k: g.detach().cpu() for k, g in taken.items()}
            raw = {k: g.cpu() for k, g in grads.items()}
        del grads
    return losses, first, raw, {k: p.detach().cpu()
                                for k, p in params.items()}, state
