"""Siamese two-tower network: a receptor and a ligand EGNN encoder.

Counterpart of ``pointvs_tpu/models/siamese.py`` (``SiameseEGNN``). The
receptor tower (``rec_tower``) is a ``SartorrasEGNN`` whose head gives a
``rec_embed_dim`` embedding; the ligand tower (``lig_tower``) one with
coordinate updates frozen and a ``lig_embed_dim`` embedding. The output
is ``silu(concat(rec, lig))`` -> Linear 64, SiLU -> Linear 32, SiLU ->
Linear ``dim_output`` (``head``; the extra SiLU on the concatenated
embedding is the reference's).

The input is a ``SiamesePair``: the receptor-only and the ligand-only
``GraphBatch`` of the same complexes, slot by slot. The towers take the
module path (a tower with attention and coordinate updates launches K2
once a layer; the frozen ligand tower aggregates with K1). The reference
has no fused path for this family, nor does the port.

The constructor takes exactly the reference's fields, so a run
directory's flags build the same model (``registry.filter_model_kwargs``).
"""
from __future__ import annotations

import torch
from torch import nn

from pointvs_tpu_torch.data.buckets import SiamesePair
from pointvs_tpu_torch.models.egnn import SartorrasEGNN
from pointvs_tpu_torch.models.layers import mlp


class SiameseEGNN(nn.Module):
    """Receptor tower, ligand tower and the joint head."""

    def __init__(self, dim_input: int, k: int = 32, num_layers: int = 4,
                 rec_embed_dim: int = 128, lig_embed_dim: int = 64,
                 edge_attention: bool = False,
                 softmax_attention: bool = False, graphnorm: bool = True,
                 residual: bool = True, normalize: bool = True,
                 tanh: bool = True, scan_layers: bool = False,
                 model_task: str = 'classification', dim_output: int = 1):
        super().__init__()
        del model_task
        tower = dict(dim_input=dim_input, k=k, num_layers=num_layers,
                     edge_attention=edge_attention,
                     softmax_attention=softmax_attention,
                     graphnorm=graphnorm, residual=residual,
                     normalize=normalize, tanh=tanh, scan_layers=scan_layers)
        self.rec_tower = SartorrasEGNN(dim_output=rec_embed_dim, **tower)
        self.lig_tower = SartorrasEGNN(dim_output=lig_embed_dim,
                                       update_coords=False, **tower)
        self.head = mlp(rec_embed_dim + lig_embed_dim, (64, 32, dim_output),
                        ('silu', 'silu', 'identity'))

    def forward(self, batch: SiamesePair, train: bool = False,
                dropout_rng=None) -> torch.Tensor:
        """The towers have no dropout; ``train`` and ``dropout_rng`` are
        the Trainer's common arguments."""
        del train, dropout_rng
        embedding = torch.cat([self.rec_tower(batch.rec),
                               self.lig_tower(batch.lig)], dim=-1)
        return self.head(nn.functional.silu(embedding))
