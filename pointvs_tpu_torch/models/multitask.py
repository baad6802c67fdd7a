"""Multitask EGNN: the Satorras trunk with a pose head and an affinity head.

Counterpart of ``pointvs_tpu/models/multitask.py``. The head is chosen at
call time by ``task``: one holding 'classification' takes the pose head
``feats_linear_layers_pose`` (Linear(k, 1)), any other the affinity head
``feats_linear_layers_affinity`` (Linear(k, dim_output), then softplus
with ``final_softplus``, else relu). Both heads exist from construction,
so a checkpoint trained on one task continues on the other. The
first-only and final-only switches give edge or node attention to the
first or the last layer alone (``_apply_switch``); a layer without
attention takes the plain aggregation (K1), one with it the attention
kernel (K2), as in ``models/egnn.py``. ``include_strain_info`` widens
both heads by the appended dE, as in the trunk's ``pool``.
"""
from __future__ import annotations

import torch

from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.models.egnn import EGNNLayer, SartorrasEGNN
from pointvs_tpu_torch.models.layers import mlp


def _apply_switch(enabled: bool, first_only: bool, final_only: bool,
                  i: int, num_layers: int) -> bool:
    """Whether layer i (0-based) has the attention that ``enabled`` turns
    on, under the first-only / final-only switches."""
    if not enabled:
        return False
    if not first_only and not final_only:
        return True
    return (first_only and i == 0) or (final_only and i == num_layers - 1)


class MultitaskSatorrasEGNN(SartorrasEGNN):
    """``SartorrasEGNN`` with per-layer attention switches and two heads;
    every other argument is ``SartorrasEGNN``'s."""

    def __init__(self, dim_input: int, k: int, dim_output: int,
                 node_attention_final_only: bool = False,
                 edge_attention_final_only: bool = False,
                 node_attention_first_only: bool = False,
                 edge_attention_first_only: bool = False,
                 final_softplus: bool = False, **kwargs):
        switches = (node_attention_final_only, edge_attention_final_only,
                    node_attention_first_only, edge_attention_first_only)
        if kwargs.get('scan_layers') and any(switches):
            # The reference's layer scan shares one configuration across
            # the stack; the switches make the layers differ.
            raise ValueError('scan_layers is incompatible with per-layer '
                             'attention switches (first/final-only)')
        super().__init__(dim_input, k, dim_output,
                         final_softplus=final_softplus, **kwargs)
        del self.feats_linear_layers
        base = self.layer_kwargs
        for i in range(self.num_layers):
            edge = _apply_switch(base['edge_attention'],
                                 edge_attention_first_only,
                                 edge_attention_final_only, i,
                                 self.num_layers)
            node = _apply_switch(base['node_attention'],
                                 node_attention_first_only,
                                 node_attention_final_only, i,
                                 self.num_layers)
            if (edge, node) != (base['edge_attention'],
                                base['node_attention']):
                self.layers[i + 1] = EGNNLayer(
                    k, **dict(base, edge_attention=edge,
                              node_attention=node))
        width = self.head_inputs(k)
        self.feats_linear_layers_pose = mlp(width, (1,), ('identity',))
        self.feats_linear_layers_affinity = mlp(
            width, (dim_output,), ('softplus' if final_softplus else 'relu',))

    def head(self, pooled: torch.Tensor, task=None) -> torch.Tensor:
        if 'classification' in (task or 'classification'):
            return self.feats_linear_layers_pose(pooled)
        return self.feats_linear_layers_affinity(pooled)

    def forward(self, batch: GraphBatch, train: bool = False,
                dropout_seed=None, dropout_rng=None,
                task: str = 'classification', capture_aux: bool = False):
        """The head ``task`` names; ``capture_aux`` as
        ``SartorrasEGNN.forward``."""
        return self._forward(batch, train, dropout_seed, dropout_rng,
                             capture_aux, task)
