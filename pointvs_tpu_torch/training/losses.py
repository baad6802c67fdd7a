"""Loss functions with padded-graph masking.

Counterpart of ``pointvs_tpu/training/losses.py``, same semantics:

- classification: BCE-with-logits per graph;
- regression: MSE or Huber (delta=1) per graph;
- multi_regression: targets (pKi, pKd, pIC50) with -1 marking a missing
  value, which contributes zero loss and zero gradient; the normaliser is
  the graph count (the reference's ``3 * mse`` over B*3 slots).

Each returns ``(loss_sum, weight)``; the caller divides by
``max(weight, 1)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits_sum(logits, labels, graph_mask):
    per_graph = F.binary_cross_entropy_with_logits(logits, labels,
                                                   reduction='none')
    return (per_graph * graph_mask).sum(), graph_mask.sum()


def _per_element(preds, targets, kind):
    if kind == 'huber':
        return F.huber_loss(preds, targets, reduction='none', delta=1.0)
    return (preds - targets) ** 2


def regression_sum(preds, targets, graph_mask, kind: str = 'mse'):
    per = _per_element(preds, targets, kind)
    return (per * graph_mask).sum(), graph_mask.sum()


def multi_regression_sum(preds, targets, graph_mask, kind: str = 'mse'):
    """Masked 3-target loss: missing targets (== -1) contribute zero."""
    valid = (targets > -0.5).to(preds.dtype)
    per = _per_element(preds, targets, kind) * valid * graph_mask[:, None]
    return per.sum(), graph_mask.sum()


def loss_fn(logits, batch, model_task: str, regression_loss: str = 'mse'):
    """Dispatch on task; returns (loss_sum, weight)."""
    if model_task == 'classification':
        return bce_with_logits_sum(logits.reshape(-1), batch.y.reshape(-1),
                                   batch.graph_mask)
    if model_task == 'regression':
        return regression_sum(logits.reshape(-1), batch.y.reshape(-1),
                              batch.graph_mask, kind=regression_loss)
    if model_task == 'multi_regression':
        return multi_regression_sum(
            logits.reshape(-1, 3), batch.y.reshape(-1, 3), batch.graph_mask,
            kind=regression_loss)
    raise ValueError(f'Unknown model_task {model_task!r}')
