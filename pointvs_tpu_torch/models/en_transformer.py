"""E(n)-equivariant transformer ("en_transformer", registry alias
"lie_transformer") over padded graph batches.

Counterpart of ``pointvs_tpu/models/en_transformer.py``. Per layer, with
pre-LayerNorm projections q, k, v split into H heads of k / H channels:

    logit_e,h = (q[s] . k[r])_h / sqrt(k / H) + edge_bias(radial, attr)_h
    a_e,h     = softmax of logit_.,h over the edges of the sender s
    h        += o_proj(sum_e a_e,h v[r]_h)  then  h += ff(ff_norm(h))
    x        += mean_e (x[s] - x[r]) * mean_h coord_mlp(a v)_e,h

(s = senders, r = receivers: the reference's ``q_dst`` is
``gather_src(q)`` and its ``k_src``/``v_src`` are ``gather_dst``.) The
reference takes one ``softmax_src`` per head; here the H heads are the
columns of one max and one K1 launch for their denominators
(``EdgeAggregator.softmax_src``), which is the same function column by
column. The aggregation is ``sum_to_src`` (K1 at width k) and the
coordinate update ``mean_to_src`` (one K1). The coordinate MLP's last
Linear is bias-free with xavier-uniform gain 0.001.

Module names follow the JAX modules (there is no reference schema):
``input_embed``, ``tf_layer_{i}.{norm,q_proj,k_proj,v_proj,o_proj,
edge_bias.{0,2},ff.{0,2},ff_norm,coord_mlp.{0,2}}`` and ``head.0``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.models.layers import mlp
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.ops.segment import masked_graph_mean_pool


class LayerNorm(nn.Module):
    """Per-row LayerNorm over the channels (biased variance, eps 1e-5)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return self.weight * (x - mean) / torch.sqrt(var + self.eps) \
            + self.bias


class EnTransformerLayer(nn.Module):
    def __init__(self, k: int, heads: int = 4, edges_in_d: int = 3,
                 update_coords: bool = True, tanh: bool = True):
        super().__init__()
        if k % heads:
            raise ValueError(f'k={k} is not a multiple of heads={heads}')
        self.k = k
        self.heads = heads
        self.head_dim = k // heads
        self.update_coords = update_coords
        self.norm = LayerNorm(k)
        self.q_proj = nn.Linear(k, k)
        self.k_proj = nn.Linear(k, k)
        self.v_proj = nn.Linear(k, k)
        self.o_proj = nn.Linear(k, k)
        # Invariant edge bias per head from (radial, edge class).
        self.edge_bias = mlp(1 + edges_in_d, (k, heads),
                             ('silu', 'identity'))
        self.ff = mlp(k, (2 * k, k), ('silu', 'identity'))
        self.ff_norm = LayerNorm(k)
        if update_coords:
            self.coord_mlp = mlp(k, (k, heads),
                                 ('silu', 'tanh' if tanh else 'identity'),
                                 final_gain=0.001, final_bias=False)

    def forward(self, h, coord, agg: EdgeAggregator, edge_attr, edge_mask,
                aux: dict | None = None):
        """-> (h, coord); an ``aux`` dict gets ``att_val`` (the heads' mean
        attention, [E, 1]) and ``intermediate_coords``."""
        normed = self.norm(h)
        q, k, v = (self.q_proj(normed), self.k_proj(normed),
                   self.v_proj(normed))
        # Sender side [coord | q], receiver side [coord | k | v]: one
        # gather each.
        src = agg.gather_src(torch.cat([coord, q], dim=1))
        dst = agg.gather_dst(torch.cat([coord, k, v], dim=1))
        coord_diff = src[:, :3] - dst[:, :3]
        radial = (coord_diff ** 2).sum(dim=1, keepdim=True)
        shape = (-1, self.heads, self.head_dim)
        q_s = src[:, 3:].reshape(shape)
        k_r = dst[:, 3:3 + self.k].reshape(shape)
        v_r = dst[:, 3 + self.k:].reshape(shape)

        bias = self.edge_bias(torch.cat([radial, edge_attr], dim=1))
        logits = (q_s * k_r).sum(-1) / math.sqrt(float(self.head_dim)) \
            + bias                                       # [E, H]
        att = agg.softmax_src(logits, mask=edge_mask)    # [E, H]
        if aux is not None:
            aux['att_val'] = att.mean(dim=1, keepdim=True)
        weighted = (att[:, :, None] * v_r).reshape(-1, self.k)
        h = h + self.o_proj(agg.sum_to_src(weighted, mask=edge_mask))
        h = h + self.ff(self.ff_norm(h))

        if self.update_coords:
            gate = self.coord_mlp(weighted).mean(dim=1, keepdim=True)
            coord = coord + agg.mean_to_src(coord_diff * gate,
                                            mask=edge_mask)
        if aux is not None:
            aux['intermediate_coords'] = coord
        return h, coord


class EnTransformer(nn.Module):
    """Input Linear, N ``EnTransformerLayer``s, masked mean pool, head."""

    def __init__(self, dim_input: int, k: int = 32, dim_output: int = 1,
                 num_layers: int = 6, heads: int = 4,
                 update_coords: bool = True, tanh: bool = True,
                 model_task: str = 'classification',
                 final_softplus: bool = False,
                 edge_shard_axis=None, scan_layers: bool = False):
        super().__init__()
        # scan_layers only changes the JAX parameter layout (models/params.py
        # reads both); model_task does not change the network.
        del scan_layers, model_task
        # The process group the edges are split over (models/egnn.py).
        self.edge_shard_axis = edge_shard_axis
        self.num_layers = num_layers
        self.input_embed = nn.Linear(dim_input, k)
        for i in range(num_layers):
            self.add_module(f'tf_layer_{i}', EnTransformerLayer(
                k, heads=heads, update_coords=update_coords, tanh=tanh))
        self.head = mlp(k, (dim_output,),
                        ('softplus' if final_softplus else 'identity',))

    def tf_layers(self):
        return [getattr(self, f'tf_layer_{i}')
                for i in range(self.num_layers)]

    def forward(self, batch: GraphBatch, train: bool = False,
                dropout_rng=None, capture_aux: bool = False):
        """Logits; with ``capture_aux``, (logits, aux) as
        ``SartorrasEGNN.forward``."""
        del train, dropout_rng   # no dropout in this family
        h = self.input_embed(batch.node_feats)
        coord = batch.coords
        agg = EdgeAggregator(batch.senders, batch.receivers,
                             batch.edge_mask, num_nodes=h.shape[0],
                             recv_perm=batch.recv_perm,
                             axis=self.edge_shard_axis)
        layers = []
        for layer in self.tf_layers():
            aux = {} if capture_aux else None
            h, coord = layer(h, coord, agg, batch.edge_attr, batch.edge_mask,
                             aux)
            layers.append(aux)
        pooled = masked_graph_mean_pool(h, batch.graph_id,
                                        batch.graph_mask.shape[0],
                                        batch.node_mask)
        out = self.head(pooled)
        if capture_aux:
            return out, {'layers': layers, 'node_embeddings': h,
                         'pooled': pooled}
        return out
