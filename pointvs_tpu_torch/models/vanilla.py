"""The dense point-cloud family: an E(n)-equivariant GNN over zero-padded
(p, v, m) batches with all-pairs messages (``dense_egnn``, registry alias
``lie_conv``).

Counterpart of ``pointvs_tpu/models/vanilla.py`` (``DenseEGNNLayer``,
``DenseEGNN``, ``dense_collate``), with the same update equations as the
Satorras EGNN: squared-distance radial; coordinate differences optionally
divided by the detached norm + 1e-8 (the diagonal and padding pairs have
radial 0, and the detached norm keeps their gradient finite); messages
masked to real, distinct pairs, and with ``cutoff`` to pairs closer than
it (``radial < cutoff**2``); a sum of messages per atom; the coordinate
update the masked mean of ``diff * phi(m_ij)``, its count clamped >= 1.
The pooled embedding is the masked mean over real atoms.

The reference computes it with plain tensor algebra on [B, N, N, K]
products (no Pallas kernel), and so does the port: ``nn.Linear`` over the
pair tensors. Their size grows with B * N^2 (``PERF.md`` gives the peak
memory at the pose set's size).

Module names: ``input_embed``, ``dense_layers.{i}`` with ``edge_mlp.{0,2}``,
``node_mlp.{0,2}`` and ``coord_mlp.{0,2}`` (the last bias-free), ``head``;
``models/params.state_dict_from_flax`` carries the JAX tree into them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from pointvs_tpu_torch.data.buckets import DenseBatch
from pointvs_tpu_torch.models.layers import mlp

EPSILON = 1e-8


class DenseEGNNLayer(nn.Module):
    """One all-pairs E(n)-GNN layer over [B, N, *] tensors."""

    def __init__(self, k: int, act: str = 'silu', residual: bool = True,
                 normalize: bool = False, tanh: bool = True,
                 cutoff: Optional[float] = None):
        super().__init__()
        self.residual = residual
        self.normalize = normalize
        self.cutoff = cutoff
        self.edge_mlp = mlp(2 * k + 1, (k, k), (act, act))
        self.node_mlp = mlp(2 * k, (k, k), (act, 'identity'))
        self.coord_mlp = mlp(k, (k, 1), (act, 'tanh' if tanh else 'identity'),
                             final_gain=0.001, final_bias=False)

    def forward(self, coords, feats, mask):
        # coords [B, N, 3], feats [B, N, K], mask [B, N]
        n = coords.shape[1]
        diff = coords[:, :, None, :] - coords[:, None, :, :]   # [B,N,N,3]
        radial = (diff ** 2).sum(dim=-1, keepdim=True)         # [B,N,N,1]
        pair_mask = mask[:, :, None] * mask[:, None, :]
        pair_mask = pair_mask * (1.0 - torch.eye(
            n, dtype=coords.dtype, device=coords.device))
        if self.cutoff is not None:
            pair_mask = pair_mask * (radial[..., 0] < self.cutoff ** 2).to(
                coords.dtype)
        if self.normalize:
            diff = diff / (torch.sqrt(radial).detach() + EPSILON)

        shape = radial.shape[:3] + (feats.shape[-1],)
        h_i = feats[:, :, None, :].expand(shape)
        h_j = feats[:, None, :, :].expand(shape)
        m_ij = self.edge_mlp(torch.cat([h_i, h_j, radial], dim=-1))
        m_ij = m_ij * pair_mask[..., None]

        trans = diff * self.coord_mlp(m_ij)
        counts = torch.clamp_min(pair_mask.sum(dim=2), 1.0)
        coords = coords + trans.sum(dim=2) / counts[..., None]

        out = self.node_mlp(torch.cat([feats, m_ij.sum(dim=2)], dim=-1))
        if self.residual:
            out = feats + out
        return coords, out


class DenseEGNN(nn.Module):
    """Input embedding, ``num_layers`` dense layers, masked mean pool and a
    linear head (the reference's LieConv / LieTransformer niche)."""

    def __init__(self, dim_input: int, dim_output: int = 1, k: int = 32,
                 num_layers: int = 6, act: str = 'silu',
                 residual: bool = True, normalize: bool = True,
                 tanh: bool = True, cutoff: Optional[float] = None,
                 model_task: str = 'classification'):
        super().__init__()
        del model_task
        self.input_embed = nn.Linear(dim_input, k)
        self.dense_layers = nn.ModuleList([DenseEGNNLayer(
            k, act=act, residual=residual, normalize=normalize, tanh=tanh,
            cutoff=cutoff) for _ in range(num_layers)])
        self.head = nn.Linear(k, dim_output)

    def forward(self, batch, train: bool = False, dropout_rng=None):
        """``batch``: a ``DenseBatch`` or the bare (p, v, m) tuple. The
        family has no dropout; ``train`` and ``dropout_rng`` are the
        Trainer's common arguments."""
        del train, dropout_rng
        p, v, m = ((batch.p, batch.v, batch.m)
                   if isinstance(batch, DenseBatch) else batch)
        return self.forward_pvm(p, v, m)

    def forward_pvm(self, p, v, m):
        mask = m.to(p.dtype)
        feats = self.input_embed(v)
        coords = p
        for layer in self.dense_layers:
            coords, feats = layer(coords, feats, mask)
        pooled = ((feats * mask[..., None]).sum(dim=1)
                  / torch.clamp_min(mask.sum(dim=1), 1.0)[..., None])
        return self.head(pooled)


def dense_collate(samples, max_len: Optional[int] = None,
                  num_graphs: Optional[int] = None) -> DenseBatch:
    """GraphSamples -> a host ``DenseBatch``: each graph's atoms padded
    with zeros to ``max_len`` (default: the largest graph), ``num_graphs``
    slots (default: one per sample), the first target value of each."""
    max_len = max_len or max(s.num_nodes for s in samples)
    slots = num_graphs or len(samples)
    if len(samples) > slots:
        raise ValueError(f'{len(samples)} samples for {slots} slots')
    feat_dim = samples[0].node_feats.shape[1]
    p = np.zeros((slots, max_len, 3), np.float32)
    v = np.zeros((slots, max_len, feat_dim), np.float32)
    m = np.zeros((slots, max_len), np.float32)
    y = np.zeros((slots,), np.float32)
    graph_mask = np.zeros((slots,), np.float32)
    for i, s in enumerate(samples):
        n = s.num_nodes
        p[i, :n] = s.coords
        v[i, :n] = s.node_feats
        m[i, :n] = 1.0
        y[i] = np.asarray(s.y, np.float32).reshape(-1)[0]
        graph_mask[i] = 1.0
    return DenseBatch(p, v, m, y, graph_mask)
