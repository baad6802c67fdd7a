"""Satorras-style E(n)-equivariant GNN over padded graph batches (forward).

Counterpart of ``pointvs_tpu/models/egnn.py`` with the same numerics:
squared-distance radial; optional coord_diff normalisation by the detached
norm + 1e-8; feature aggregation is a segment sum at the edge's first index
("senders"); the coordinate update a segment mean with count clamped >= 1;
softmax edge attention normalised per destination; plain / ReZero / gated
residuals for nodes and edge messages.

Module names follow the reference PointVS state_dict schema (the one
``pointvs_tpu/models/torch_import.py`` reads), so a port checkpoint loads
into the JAX package unchanged: ``layers.0.m`` embeds the input;
``layers.{i}`` holds ``edge_mlp.{0,2}``, ``node_mlp.{0,1,3}`` (index 1 is
the GraphNorm), ``coord_mlp.{0,2}``, ``att_mlp.0``, ``node_att_mlp.0`` and
``{edge,node}_gate_parameter``; ``feats_linear_layers`` is the head.
"""
from __future__ import annotations

import torch
from torch import nn

from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.models.layers import activation, mlp
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.ops.graphnorm import GraphNorm
from pointvs_tpu_torch.ops.segment import masked_graph_mean_pool

_ROADMAP = 'see ROADMAP.md, Queue 1'
EPSILON = 1e-8   # added to the detached norm when normalising coord_diff


class EGNNLayer(nn.Module):
    """One E(n)-GNN message-passing layer (ref EGNNLayer)."""

    def __init__(self, k: int, act: str = 'silu',
                 residual: bool = True, edge_residual: bool = False,
                 edge_attention: bool = False, normalize: bool = False,
                 tanh: bool = False, graphnorm: bool = False,
                 graphnorm_whole_batch: bool = False,
                 update_coords: bool = True,
                 permutation_invariance: bool = False,
                 node_attention: bool = False,
                 attention_activation_fn: str = 'sigmoid',
                 gated_residual: bool = False, rezero: bool = False,
                 softmax_attention: bool = False):
        super().__init__()
        if gated_residual and rezero:
            raise ValueError('gated_residual and rezero are incompatible')
        self.residual = residual
        self.edge_residual = edge_residual
        self.edge_attention = edge_attention
        self.normalize = normalize
        self.graphnorm = graphnorm
        self.update_coords = update_coords
        self.permutation_invariance = permutation_invariance
        self.node_attention = node_attention
        self.attention_activation_fn = attention_activation_fn
        self.gated_residual = gated_residual
        self.rezero = rezero
        self.softmax_attention = softmax_attention

        # [h_s, h_r | h_s + h_r, |dx|^2, 3 edge-class columns]
        edge_in = (1 if permutation_invariance else 2) * k + 1 + 3
        self.edge_mlp = mlp(edge_in, (k, k), (act, act))
        self.node_mlp = nn.Sequential(
            nn.Linear(2 * k, k),
            GraphNorm(k, whole_batch=graphnorm_whole_batch) if graphnorm
            else nn.Identity(),
            activation(act),
            nn.Linear(k, k))
        if update_coords:
            self.coord_mlp = mlp(k, (k, 1),
                                 (act, 'tanh' if tanh else 'identity'),
                                 final_gain=0.001, final_bias=False)
        if edge_attention:
            self.att_mlp = nn.Sequential(nn.Linear(k, 1))
        if node_attention:
            self.node_att_mlp = nn.Sequential(nn.Linear(k, 1))
        gate_init = 0.0 if rezero else 0.5
        if rezero or gated_residual:
            if edge_residual:
                self.edge_gate_parameter = nn.Parameter(
                    torch.full((1,), gate_init))
            if residual:
                self.node_gate_parameter = nn.Parameter(
                    torch.full((1,), gate_init))

    def _gated(self, gate, new, old):
        if self.rezero:
            return old + gate * new
        if self.gated_residual:
            gate = torch.relu(gate)
            return gate * new + (1 - gate) * old
        return new + old

    def forward(self, h, coord, edge_messages, agg: EdgeAggregator,
                edge_attr, edge_mask, node_mask, graph_id, num_graphs: int):
        # h and coord ride one gather per edge endpoint.
        k = h.shape[1]
        hc = torch.cat([h, coord], dim=1)
        if agg.inv_recv_perm is not None:
            hc_s, hc_r = agg.gather_pair(hc)
        else:
            hc_s, hc_r = agg.gather_src(hc), agg.gather_dst(hc)
        h_s, coord_s = hc_s[:, :k], hc_s[:, k:k + 3]
        h_r, coord_r = hc_r[:, :k], hc_r[:, k:k + 3]

        # --- coord2radial (ref :178-187) ---
        coord_diff = coord_s - coord_r
        radial = (coord_diff ** 2).sum(dim=1, keepdim=True)
        if self.normalize:
            coord_diff = coord_diff / (torch.sqrt(radial).detach()
                                       + EPSILON)

        # --- edge model (ref :123-132) ---
        edge_in = ([h_s + h_r, radial] if self.permutation_invariance
                   else [h_s, h_r, radial])
        edge_feat = self.edge_mlp(torch.cat(edge_in + [edge_attr], dim=1))

        # --- edge-message residual (ref :194-202) ---
        if self.edge_residual and edge_messages is not None:
            edge_feat = self._gated(
                getattr(self, 'edge_gate_parameter', None), edge_feat,
                edge_messages)

        # --- coord model (ref :168-176) + node aggregation ---
        sigmoid_att = (self.edge_attention and not self.softmax_attention
                       and self.attention_activation_fn == 'sigmoid')
        if self.edge_attention and self.update_coords and (
                self.softmax_attention or sigmoid_att):
            # Attention weighting folded into the aggregation kernel.
            att_logits = self.att_mlp(edge_feat)
            trans = coord_diff * self.coord_mlp(edge_feat)
            fused = (agg.fused_softmax_aggregate if self.softmax_attention
                     else agg.fused_sigmoid_aggregate)
            agg_feats, coord_delta = fused(edge_feat, att_logits, trans,
                                           mask=edge_mask)
            coord = coord + coord_delta
        else:
            messages = edge_feat
            if self.edge_attention:
                att_logits = self.att_mlp(edge_feat)
                att_val = (agg.softmax_src(att_logits, mask=edge_mask)
                           if self.softmax_attention else
                           activation(self.attention_activation_fn)(
                               att_logits))
                messages = att_val * edge_feat
            if self.update_coords:
                trans = coord_diff * self.coord_mlp(edge_feat)
                agg_feats, coord_delta = agg.fused_sum_mean_to_src(
                    messages, trans, mask=edge_mask)
                coord = coord + coord_delta
            else:
                agg_feats = agg.sum_to_src(messages, mask=edge_mask)

        # --- node model (ref :134-166) ---
        lin1, norm, act, lin2 = self.node_mlp
        out = lin1(torch.cat([h, agg_feats], dim=1))
        if self.graphnorm:
            out = norm(out, graph_id, num_graphs, node_mask)
        out = lin2(act(out))
        if self.node_attention:
            out = out * activation(self.attention_activation_fn)(
                self.node_att_mlp(out))
        if self.residual:
            out = self._gated(getattr(self, 'node_gate_parameter', None),
                              out, h)
        return out, coord, edge_feat


class InputEmbedding(nn.Module):
    """``layers.0``: the reference's PygLinearPass around one Linear."""

    def __init__(self, dim_input: int, k: int):
        super().__init__()
        self.m = nn.Linear(dim_input, k)

    def forward(self, x):
        return self.m(x)


class SartorrasEGNN(nn.Module):
    """Input embedding + N EGNN layers + pooled FC head
    (ref SartorrasEGNN.build_net, egnn_satorras.py:209-329)."""

    def __init__(self, dim_input: int, k: int, dim_output: int,
                 num_layers: int = 4, act: str = 'silu',
                 residual: bool = True, edge_residual: bool = False,
                 edge_attention: bool = False, normalize: bool = True,
                 tanh: bool = True, dropout: float = 0.0,
                 graphnorm: bool = True, graphnorm_whole_batch: bool = False,
                 multi_fc: bool = False, update_coords: bool = True,
                 permutation_invariance: bool = False,
                 attention_activation_fn: str = 'sigmoid',
                 node_attention: bool = False, gated_residual: bool = False,
                 rezero: bool = False, model_task: str = 'classification',
                 include_strain_info: bool = False,
                 final_softplus: bool = False,
                 softmax_attention: bool = False,
                 edge_shard_axis: str | None = None, remat: bool = False,
                 bf16: bool = False, scan_layers: bool = False):
        super().__init__()
        # scan_layers only changes the JAX parameter layout; the port's
        # state_dict is per-layer either way (models/params.py carries both).
        del scan_layers, model_task
        unsupported = {
            'bf16': (bf16, 'mixed precision'),
            'remat': (remat, 'training'),
            'dropout': (dropout > 0, 'training'),
            'include_strain_info': (include_strain_info,
                                    'strain-energy inputs'),
            'edge_shard_axis': (edge_shard_axis is not None, 'scale-out'),
        }
        for flag, (on, item) in unsupported.items():
            if on:
                raise NotImplementedError(
                    f'{flag} is not in the port yet ({item}; {_ROADMAP})')
        layer_kwargs = dict(
            act=act, residual=residual, edge_residual=edge_residual,
            edge_attention=edge_attention, normalize=normalize, tanh=tanh,
            graphnorm=graphnorm, graphnorm_whole_batch=graphnorm_whole_batch,
            update_coords=update_coords,
            permutation_invariance=permutation_invariance,
            node_attention=node_attention,
            attention_activation_fn=attention_activation_fn,
            gated_residual=gated_residual, rezero=rezero,
            softmax_attention=softmax_attention)
        self.layers = nn.ModuleList(
            [InputEmbedding(dim_input, k)]
            + [EGNNLayer(k, **layer_kwargs) for _ in range(num_layers)])
        if multi_fc:
            dims, acts = (32, 16, dim_output), (act, act, 'identity')
        else:
            dims, acts = (dim_output,), ('identity',)
        if final_softplus:
            acts = acts[:-1] + ('softplus',)
        self.feats_linear_layers = mlp(k, dims, acts)

    def embed(self, batch: GraphBatch) -> torch.Tensor:
        """Input linear + message-passing stack -> node embeddings."""
        h = self.layers[0](batch.node_feats)
        coord = batch.coords
        agg = EdgeAggregator(batch.senders, batch.receivers,
                             batch.edge_mask, num_nodes=h.shape[0],
                             inv_recv_perm=batch.inv_recv_perm)
        num_graphs = batch.graph_mask.shape[0]
        edge_messages = None
        for layer in self.layers[1:]:
            h, coord, edge_messages = layer(
                h, coord, edge_messages, agg, batch.edge_attr,
                batch.edge_mask, batch.node_mask, batch.graph_id, num_graphs)
        return h

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        h = self.embed(batch)
        pooled = masked_graph_mean_pool(h, batch.graph_id,
                                        batch.graph_mask.shape[0],
                                        batch.node_mask)
        return self.feats_linear_layers(pooled)
