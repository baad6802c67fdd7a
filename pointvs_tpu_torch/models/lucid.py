"""Lucidrains-style EGNN ("lucid") over padded graph batches.

Counterpart of ``pointvs_tpu/models/lucid.py`` with the same numerics:

- coordinates ride in the first 3 columns of the node state;
- the squared distance is the edge's distance feature, optionally
  fourier-encoded (``fourier_encode_dist``);
- the message input is [x_i, x_j, edge_attr, distance features] with
  x_i = h[receivers] (``gather_dst``) and x_j = h[senders]
  (``gather_src``), and both the coordinate and the feature aggregation
  are means at the **receiver** (``mean_to_dst``: kernel K1 over
  ``receivers_sorted``), the pyg convention of the reference;
- the coordinate update comes before the soft-edge gate; ``CoorsNorm``
  (clamped inside the sqrt) on the relative coordinates;
- ``GraphLayerNorm``: per graph, one scalar mean and variance over the
  real nodes x channels;
- xavier-normal weights and zero biases.

Module names follow the reference PygLucidEGNN state_dict schema (the one
``pointvs_tpu/models/torch_import._lucid_flat`` reads): ``layers.0.m``
embeds the features; ``layers.{i}`` holds ``edge_mlp.{0,3}``,
``edge_weight.{0[,2]}``, ``node_norm``, ``coors_norm``,
``node_mlp.{0,2,4}`` (thin: ``.0`` and the GraphNorm ``.2``) and
``coors_mlp.{0[,3]}``; the head is ``feats_linear_layers.0``. The
reference's Dropout modules sit at its indices with no parameters.

Dropout (``dropout`` > 0, ``train=True``) follows the first Linear of the
edge and coordinate MLPs and the node MLP's first Linear, as in the
reference. A training forward takes the step's raw JAX key
(``dropout_rng``, what the reference passes as ``rngs={'dropout': ...}``);
each site's key is the one flax derives for it (``ops/prng.lucid_site_key``:
the scope path, and under ``scan_layers`` the layer's row of the key's
split), and its mask is flax's ``bernoulli`` draw (``layers.Dropout``, on
the card the kernel of ``ops/dropout.py``). The reference's own node-MLP
dropout is an unnamed ``nn.Dropout`` in a ``setup`` module, which flax
refuses (``AssignSubModuleError``) whenever ``dropout`` > 0; the port
gives that site the key flax names it by in a compact layer,
``Dropout_0`` in the layer's scope (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import torch
from torch import nn

from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.models.layers import (CoorsNorm, Dropout,
                                             XavierNormalLinear,
                                             fourier_encode_dist)
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.ops.graphnorm import (GraphNorm, _masked_graph_mean,
                                             broadcast_per_graph)
from pointvs_tpu_torch.ops.prng import LUCID_SITES, lucid_site_key
from pointvs_tpu_torch.ops.segment import masked_graph_mean_pool



class GraphLayerNorm(nn.Module):
    """pyg LayerNorm in its graph mode: per graph, a scalar mean and
    variance over the real nodes x channels, then a per-channel affine.
    Padding rows come out zero (they have no statistics)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x, graph_id, num_graphs: int, node_mask):
        mean = _masked_graph_mean(x.mean(-1, keepdim=True), graph_id,
                                  num_graphs, node_mask)
        centred = x - broadcast_per_graph(mean, graph_id, num_graphs)
        var = _masked_graph_mean((centred * centred).mean(-1, keepdim=True),
                                 graph_id, num_graphs, node_mask)
        out = centred / torch.sqrt(
            broadcast_per_graph(var, graph_id, num_graphs) + self.eps)
        return torch.where(node_mask[:, None] > 0,
                           out * self.weight + self.bias, out.new_zeros(()))


def _run(seq: nn.Sequential, x, key):
    """A lucid MLP forward; its Dropout draws under ``key``."""
    for module in seq:
        x = module(x, key) if isinstance(module, Dropout) else module(x)
    return x


class LucidEGNNLayer(nn.Module):
    """One EGNN_Sparse layer after the reference's PygLucidEGNN rewiring."""

    def __init__(self, k: int, edge_attr_dim: int = 3,
                 fourier_features: int = 0, soft_edge: bool = False,
                 thick_attention: bool = False, norm_feats: bool = False,
                 norm_coors: bool = False, update_coors: bool = True,
                 dropout: float = 0.0, tanh: bool = True,
                 thin_mlps: bool = False, graphnorm: bool = False,
                 graphnorm_whole_batch: bool = False,
                 node_final_act: bool = False, batch_shard_axis=None):
        super().__init__()
        self.fourier_features = fourier_features
        self.soft_edge = soft_edge
        self.norm_feats = norm_feats
        self.norm_coors = norm_coors
        self.update_coors = update_coors
        self.graphnorm = graphnorm
        final = nn.Tanh() if tanh else nn.Identity()
        eid = fourier_features * 2 + edge_attr_dim + 1 + k * 2
        self.edge_mlp = nn.Sequential(
            XavierNormalLinear(eid, eid * 2), Dropout(dropout), nn.SiLU(),
            XavierNormalLinear(eid * 2, k), nn.SiLU())
        if soft_edge:
            self.edge_weight = (
                nn.Sequential(XavierNormalLinear(k, k), nn.SiLU(),
                              XavierNormalLinear(k, 1), nn.Sigmoid())
                if thick_attention else
                nn.Sequential(XavierNormalLinear(k, 1), nn.Sigmoid()))
        if norm_feats:
            self.node_norm = GraphLayerNorm(k)
        if norm_coors and update_coors:   # the JAX layer's parameters
            self.coors_norm = CoorsNorm()
        width = k if thin_mlps else 2 * k
        norm = (GraphNorm(width, whole_batch=graphnorm_whole_batch,
                          batch_axis=batch_shard_axis)
                if graphnorm else nn.Identity())
        last = nn.SiLU() if node_final_act else nn.Identity()
        if thin_mlps:
            self.node_mlp = nn.Sequential(
                XavierNormalLinear(2 * k, k), Dropout(dropout), norm,
                last)
        else:
            self.node_mlp = nn.Sequential(
                XavierNormalLinear(2 * k, 2 * k), Dropout(dropout), norm,
                nn.SiLU(), XavierNormalLinear(2 * k, k), last)
        if update_coors:
            self.coors_mlp = (
                nn.Sequential(XavierNormalLinear(k, 1), Dropout(dropout),
                              final) if thin_mlps else
                nn.Sequential(XavierNormalLinear(k, 4 * k),
                              Dropout(dropout), nn.SiLU(),
                              XavierNormalLinear(4 * k, 1), final))

    def forward(self, h, batch: GraphBatch, agg: EdgeAggregator,
                num_graphs: int, keys=None, aux: dict | None = None):
        """``keys``: each dropout site's JAX key by site name
        (``prng.LUCID_SITES``), or None (no dropout). An ``aux`` dict gets
        ``intermediate_coords`` and, with the soft edge gate, ``att_val``
        (the reference's ``capture_aux``)."""
        keys = keys or {}
        if agg.inv_recv_perm is not None:
            h_j, h_i = agg.gather_pair(h)   # h[senders], h[receivers]
        else:
            h_j, h_i = agg.gather_src(h), agg.gather_dst(h)
        coors, feats = h[:, :3], h[:, 3:]
        rel_coors = h_j[:, :3] - h_i[:, :3]
        rel_dist = (rel_coors ** 2).sum(-1, keepdim=True)
        dist_feats = (fourier_encode_dist(rel_dist, self.fourier_features)
                      if self.fourier_features > 0 else rel_dist)
        m_ij = _run(self.edge_mlp, torch.cat(
            [h_i[:, 3:], h_j[:, 3:], batch.edge_attr, dist_feats], dim=-1),
            keys.get('edge'))

        if self.update_coors:
            coor_wij = _run(self.coors_mlp, m_ij, keys.get('coors'))
            if self.norm_coors:
                rel_coors = self.coors_norm(rel_coors)
            coors = coors + agg.mean_to_dst(coor_wij * rel_coors)
        if aux is not None:
            aux['intermediate_coords'] = coors
        if self.soft_edge:
            att_val = self.edge_weight(m_ij)
            if aux is not None:
                aux['att_val'] = att_val
            m_ij = m_ij * att_val
        m_i = agg.mean_to_dst(m_ij)

        hidden = (self.node_norm(feats, batch.graph_id, num_graphs,
                                 batch.node_mask)
                  if self.norm_feats else feats)
        lin1, drop, norm, *rest = self.node_mlp
        out = drop(lin1(torch.cat([hidden, m_i], dim=-1)), keys.get('node'))
        if self.graphnorm:
            out = norm(out, batch.graph_id, num_graphs, batch.node_mask)
        for module in rest:
            out = module(out)
        return torch.cat([coors, feats + out], dim=-1)


class LucidEmbedding(nn.Module):
    """``layers.0``: the reference's PygLinearPass around one Linear."""

    def __init__(self, dim_input: int, k: int):
        super().__init__()
        self.m = XavierNormalLinear(dim_input, k)

    def forward(self, x):
        return self.m(x)


class LucidEGNN(nn.Module):
    """Linear embedding of the features (coordinates carried beside them),
    N ``LucidEGNNLayer``s, masked mean pool and a linear head."""

    def __init__(self, dim_input: int, k: int, dim_output: int,
                 num_layers: int = 4, dropout: float = 0.0,
                 norm_coords: bool = True, norm_feats: bool = True,
                 fourier_features: int = 0, attention: bool = False,
                 thick_attention: bool = False, tanh: bool = True,
                 update_coords: bool = True, graphnorm: bool = False,
                 graphnorm_whole_batch: bool = False,
                 thin_mlps: bool = False, node_final_act: bool = False,
                 model_task: str = 'classification',
                 edge_shard_axis=None, batch_shard_axis=None,
                 scan_layers: bool = False):
        super().__init__()
        # scan_layers changes the JAX parameter layout (models/params.py
        # reads both) and the dropout keys' scopes; model_task does not
        # change the network.
        del model_task
        self.scan_layers = scan_layers
        # Scale-out process groups (see models/egnn.py).
        self.edge_shard_axis = edge_shard_axis
        self.num_layers = num_layers
        self.dropout = dropout
        self.layers = nn.ModuleList([LucidEmbedding(dim_input, k)] + [
            LucidEGNNLayer(
                k, fourier_features=fourier_features, soft_edge=attention,
                thick_attention=thick_attention, norm_feats=norm_feats,
                norm_coors=norm_coords, update_coors=update_coords,
                dropout=dropout, tanh=tanh, thin_mlps=thin_mlps,
                graphnorm=graphnorm,
                graphnorm_whole_batch=graphnorm_whole_batch,
                node_final_act=node_final_act,
                batch_shard_axis=batch_shard_axis)
            for _ in range(num_layers)])
        self.feats_linear_layers = nn.Sequential(
            XavierNormalLinear(k, dim_output))

    def _site_keys(self, layer: int, dropout_rng) -> dict:
        return {site: lucid_site_key(dropout_rng, layer, site,
                                     self.num_layers, self.scan_layers)
                for site in LUCID_SITES}

    def forward(self, batch: GraphBatch, train: bool = False,
                dropout_rng=None, capture_aux: bool = False):
        """Logits; a training forward with dropout takes the step's raw
        JAX key ``dropout_rng`` (uint32[2]). With ``capture_aux``, (logits,
        aux): each layer's aux dict (``layers``), ``node_embeddings`` and
        ``pooled``."""
        dropping = train and self.dropout > 0
        if dropping and dropout_rng is None:
            raise ValueError('a training forward with dropout needs a '
                             'dropout_rng')
        h = torch.cat([batch.coords, self.layers[0](batch.node_feats)],
                      dim=-1)
        agg = EdgeAggregator(batch.senders, batch.receivers,
                             batch.edge_mask, num_nodes=h.shape[0],
                             recv_perm=batch.recv_perm,
                             inv_recv_perm=batch.inv_recv_perm,
                             axis=self.edge_shard_axis)
        num_graphs = batch.graph_mask.shape[0]
        layers = []
        for i, layer in enumerate(self.layers[1:]):
            aux = {} if capture_aux else None
            h = layer(h, batch, agg, num_graphs,
                      self._site_keys(i, dropout_rng) if dropping else None,
                      aux)
            layers.append(aux)
        pooled = masked_graph_mean_pool(h[:, 3:], batch.graph_id, num_graphs,
                                        batch.node_mask)
        out = self.feats_linear_layers(pooled)
        if capture_aux:
            return out, {'layers': layers, 'node_embeddings': h[:, 3:],
                         'pooled': pooled}
        return out
