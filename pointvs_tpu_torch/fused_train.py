"""Differentiable fused forward for training.

Counterpart of ``pointvs_tpu/fused_train.py``: every layer's edge pass is
``FusedEdgePass`` (forward K3, recompute backward K4), and the node side
is the model's own modules. Gathers go through ``EdgeAggregator``, so their
backward is K1; the coordinate normalisation divides by the detached norm
(``.detach()``, the reference's ``stop_gradient``); GraphNorm statistics
are broadcast per graph by one-hot products. The layer walk is
``inference_engine.fused_network``, with each layer's own attention mode
(the multitask switches) and the head that ``task`` names.
"""
from __future__ import annotations

import torch

from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.inference_engine import fused_network, \
    supports_fusion


def supports_fused_training(model, batch: GraphBatch) -> bool:
    """The model conditions of ``supports_fusion``. The reference also
    gates on the TPU's VMEM per window; the CUDA kernels have no such
    capacity."""
    del batch
    return supports_fusion(model)


def fused_apply(model, batch: GraphBatch, task=None) -> torch.Tensor:
    """Training forward equal to ``model(batch[, task=task])``,
    differentiable through K4 in every layer; a multitask model's head is
    the one ``task`` names."""
    if not supports_fusion(model):
        raise ValueError('this model configuration has no fused path '
                         '(see inference_engine.supports_fusion)')
    return fused_network(model, batch, differentiable=True, task=task)
