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

``include_strain_info`` appends each graph's strain energy dE (column 0
of ``batch.strain``) to the pooled embedding, so the head takes k + 1
inputs (``pool``, which the fused paths share).

``bf16`` is the reference's mixed precision (``--bf16``): the input
embedding and every layer's MLPs compute in bfloat16 (``layers.Linear``)
from f32 parameters; coordinates, radial and coordinate terms stay f32.
The features ride the f32 ``[h | coord]`` gather exactly (a bf16 value is
an f32 one), so the gather's backward sums the cotangents in f32 through
K1 and rounds to bf16 once, as the reference's packed mixed gather does.
Messages, attention logits and coordinate terms are cast to f32 where the
reference casts them, before K1/K2, and the aggregates back to bf16. The
ReZero and gated residual gates are cast to bf16 as the reference casts
them (a [1] f32 tensor would promote the product to f32 here). Pooling
takes f32 node embeddings, so the head and the logits are f32.

Under ``--double`` the parameters are float64 and the batch arrives in
float64 (``parallel/steps.py``); ``pool`` still rounds the node
embeddings to f32 before the head, as the reference's ``pool`` does.

Training options: ``dropout`` drops undirected edges (``ops/edge_dropout``)
when the forward is called with ``train=True``, by the seed the reference
draws from the step's JAX key (``dropout_rng``:
``ops/prng.egnn_edge_dropout_seed``, flax's ``make_rng('dropout')`` in the
model's root scope and ``randint`` to int32 max) or by an explicit
``dropout_seed``; ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as the reference's ``nn.remat``.

Under a profiler (``tracing.py``) each message-passing layer of
``embed`` is a span ``pointvs.model.layer``, and inside it the layer's
aggregation (K2/K1 or their plain forms) is a span
``pointvs.model.aggregate``.

Scale-out (``parallel/``): ``edge_shard_axis`` is the process group a
batch's edge list is split over (each rank holds one shard and the
replicated nodes; every aggregation sums over the group), and
``batch_shard_axis`` the data-parallel group the strict GraphNorm's
whole-batch statistics sum over. The Trainer sets both and keeps them out
of ``model_kwargs.yaml``, so a run trained sharded loads on one device.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.models.layers import Linear, activation, mlp
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.ops.edge_dropout import undirected_edge_dropout
from pointvs_tpu_torch.ops.graphnorm import GraphNorm
from pointvs_tpu_torch.ops.prng import egnn_edge_dropout_seed
from pointvs_tpu_torch.ops.segment import masked_graph_mean_pool
from pointvs_tpu_torch.tracing import span

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
                 softmax_attention: bool = False,
                 dtype: torch.dtype | None = None,
                 batch_shard_axis=None):
        super().__init__()
        if gated_residual and rezero:
            raise ValueError('gated_residual and rezero are incompatible')
        self.residual = residual
        self.edge_residual = edge_residual
        self.edge_attention = edge_attention
        self.normalize = normalize
        self.tanh = tanh
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
        self.edge_mlp = mlp(edge_in, (k, k), (act, act), dtype=dtype)
        self.node_mlp = nn.Sequential(
            Linear(2 * k, k, dtype=dtype),
            GraphNorm(k, whole_batch=graphnorm_whole_batch,
                      batch_axis=batch_shard_axis) if graphnorm
            else nn.Identity(),
            activation(act),
            Linear(k, k, dtype=dtype))
        if update_coords:
            self.coord_mlp = mlp(k, (k, 1),
                                 (act, 'tanh' if tanh else 'identity'),
                                 final_gain=0.001, final_bias=False,
                                 dtype=dtype)
        if edge_attention:
            self.att_mlp = nn.Sequential(Linear(k, 1, dtype=dtype))
        if node_attention:
            self.node_att_mlp = nn.Sequential(Linear(k, 1, dtype=dtype))
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
            return old + gate.to(new.dtype) * new
        if self.gated_residual:
            gate = torch.relu(gate).to(new.dtype)
            return gate * new + (1 - gate) * old
        return new + old

    def forward(self, h, coord, edge_messages, agg: EdgeAggregator,
                edge_attr, edge_mask, node_mask, graph_id, num_graphs: int,
                aux: dict | None = None):
        """-> (h, coord, edge messages). With an ``aux`` dict (attribution's
        ``capture_aux``) the layer takes the unfused branch, as the
        reference does, and fills ``att_val`` (the per-edge attention, with
        edge attention), ``intermediate_coords`` and ``node_att_val`` (with
        node attention)."""
        # h and coord ride one gather per edge endpoint, in coord's dtype
        # (bf16 h exactly as f32; its cotangents are summed in f32).
        k = h.shape[1]
        hc = torch.cat([h.to(coord.dtype), coord], dim=1)
        if agg.inv_recv_perm is not None:
            hc_s, hc_r = agg.gather_pair(hc)
        else:
            hc_s, hc_r = agg.gather_src(hc), agg.gather_dst(hc)
        h_s, coord_s = hc_s[:, :k].to(h.dtype), hc_s[:, k:k + 3]
        h_r, coord_r = hc_r[:, :k].to(h.dtype), hc_r[:, k:k + 3]

        # --- coord2radial (ref :178-187) ---
        coord_diff = coord_s - coord_r
        radial = (coord_diff ** 2).sum(dim=1, keepdim=True)
        if self.normalize:
            coord_diff = coord_diff / (torch.sqrt(radial).detach()
                                       + EPSILON)

        # --- edge model (ref :123-132); radial and the edge classes
        # enter the MLP in h's dtype ---
        radial_h, attr_h = radial.to(h.dtype), edge_attr.to(h.dtype)
        edge_in = ([h_s + h_r, radial_h] if self.permutation_invariance
                   else [h_s, h_r, radial_h])
        edge_feat = self.edge_mlp(torch.cat(edge_in + [attr_h], dim=1))

        # --- edge-message residual (ref :194-202) ---
        if self.edge_residual and edge_messages is not None:
            edge_feat = self._gated(
                getattr(self, 'edge_gate_parameter', None), edge_feat,
                edge_messages)

        # --- coord model (ref :168-176) + node aggregation; the kernels
        # sum in coord's dtype (f32 under --bf16) ---
        sigmoid_att = (self.edge_attention and not self.softmax_attention
                       and self.attention_activation_fn == 'sigmoid')
        if self.edge_attention and self.update_coords and (
                self.softmax_attention or sigmoid_att) and aux is None:
            # Attention weighting folded into the aggregation kernel.
            att_logits = self.att_mlp(edge_feat)
            trans = coord_diff * self.coord_mlp(edge_feat)
            fused = (agg.fused_softmax_aggregate if self.softmax_attention
                     else agg.fused_sigmoid_aggregate)
            with span('pointvs.model.aggregate'):
                agg_feats, coord_delta = fused(
                    edge_feat.to(coord.dtype), att_logits.to(coord.dtype),
                    trans, mask=edge_mask)
            agg_feats = agg_feats.to(h.dtype)
            coord = coord + coord_delta
        else:
            messages = edge_feat
            if self.edge_attention:
                att_logits = self.att_mlp(edge_feat)
                att_val = (agg.softmax_src(att_logits, mask=edge_mask)
                           if self.softmax_attention else
                           activation(self.attention_activation_fn)(
                               att_logits))
                if aux is not None:
                    aux['att_val'] = att_val
                messages = att_val * edge_feat
            if self.update_coords:
                trans = coord_diff * self.coord_mlp(edge_feat)
                with span('pointvs.model.aggregate'):
                    agg_feats, coord_delta = agg.fused_sum_mean_to_src(
                        messages.to(coord.dtype), trans, mask=edge_mask)
                agg_feats = agg_feats.to(h.dtype)
                coord = coord + coord_delta
            else:
                with span('pointvs.model.aggregate'):
                    agg_feats = agg.sum_to_src(messages, mask=edge_mask)
        if aux is not None:
            aux['intermediate_coords'] = coord

        out = self.node_update(h, agg_feats, node_mask, graph_id,
                               num_graphs, aux=aux)
        return out, coord, edge_feat

    def node_update(self, h, agg_feats, node_mask, graph_id,
                    num_graphs: int, per_graph_norm: bool = False,
                    aux: dict | None = None):
        """Node model (ref :134-166): node MLP with GraphNorm, node
        attention and the residual. Shared with the fused paths
        (``inference_engine.py``), whose GraphNorm takes per-graph
        statistics also under ``graphnorm_whole_batch``
        (``per_graph_norm``), as the reference's fused paths do."""
        lin1, norm, act, lin2 = self.node_mlp
        out = lin1(torch.cat([h, agg_feats], dim=1))
        if self.graphnorm:
            out = norm(out, graph_id, num_graphs, node_mask,
                       per_graph=per_graph_norm)
        out = lin2(act(out))
        if self.node_attention:
            node_att = activation(self.attention_activation_fn)(
                self.node_att_mlp(out))
            if aux is not None:
                aux['node_att_val'] = node_att
            out = out * node_att
        if self.residual:
            out = self._gated(getattr(self, 'node_gate_parameter', None),
                              out, h)
        return out


class InputEmbedding(nn.Module):
    """``layers.0``: the reference's PygLinearPass around one Linear."""

    def __init__(self, dim_input: int, k: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.m = Linear(dim_input, k, dtype=dtype)

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
                 edge_shard_axis=None, batch_shard_axis=None,
                 remat: bool = False, bf16: bool = False,
                 scan_layers: bool = False):
        super().__init__()
        # scan_layers only changes the JAX parameter layout; the port's
        # state_dict is per-layer either way (models/params.py carries both).
        del scan_layers, model_task
        self.edge_shard_axis = edge_shard_axis
        self.bf16 = bf16
        dtype = torch.bfloat16 if bf16 else None
        self.num_layers = num_layers
        self.include_strain_info = include_strain_info
        self.dropout = dropout
        self.remat = remat
        self.permutation_invariance = permutation_invariance
        self.edge_residual = edge_residual
        self.gated_residual = gated_residual
        self.rezero = rezero
        layer_kwargs = dict(
            act=act, residual=residual, edge_residual=edge_residual,
            edge_attention=edge_attention, normalize=normalize, tanh=tanh,
            graphnorm=graphnorm, graphnorm_whole_batch=graphnorm_whole_batch,
            update_coords=update_coords,
            permutation_invariance=permutation_invariance,
            node_attention=node_attention,
            attention_activation_fn=attention_activation_fn,
            gated_residual=gated_residual, rezero=rezero,
            softmax_attention=softmax_attention, dtype=dtype,
            batch_shard_axis=batch_shard_axis)
        self.layer_kwargs = layer_kwargs
        self.layers = nn.ModuleList(
            [InputEmbedding(dim_input, k, dtype)]
            + [EGNNLayer(k, **layer_kwargs) for _ in range(num_layers)])
        if multi_fc:
            dims, acts = (32, 16, dim_output), (act, act, 'identity')
        else:
            dims, acts = (dim_output,), ('identity',)
        if final_softplus:
            acts = acts[:-1] + ('softplus',)
        self.feats_linear_layers = mlp(self.head_inputs(k), dims, acts)

    def head_inputs(self, k: int) -> int:
        """Width of the pooled features the head reads."""
        return k + (1 if self.include_strain_info else 0)

    def embed(self, batch: GraphBatch, train: bool = False,
              dropout_seed=None, dropout_rng=None,
              aux_layers: list | None = None) -> torch.Tensor:
        """Input linear + message-passing stack -> node embeddings; with
        ``train``, ``dropout`` of the undirected edges masked out as drawn
        by ``dropout_seed`` (a uint32), or by the seed the reference draws
        from the step's raw JAX key ``dropout_rng``. A list ``aux_layers``
        gets each layer's aux dict (``EGNNLayer.forward``)."""
        if train and self.dropout > 0:
            if dropout_seed is None and dropout_rng is not None:
                dropout_seed = egnn_edge_dropout_seed(dropout_rng)
            if dropout_seed is None:
                raise ValueError('a training forward with dropout needs a '
                                 'dropout_rng or a dropout_seed')
            batch = batch._replace(edge_mask=undirected_edge_dropout(
                batch.senders, batch.receivers, batch.edge_mask,
                self.dropout, dropout_seed))
        width = batch.node_feats.shape[1]
        dim_input = self.layers[0].m.in_features
        if width != dim_input:
            # The reference stops here too (flax's parameter shape check):
            # e.g. --synthpharm without --compact, whose 12 features meet
            # the dataset's feature_dim of 22.
            raise ValueError(
                f'the batch has {width} node features but the model was '
                f'built for dim_input={dim_input}')
        h = self.layers[0](batch.node_feats)
        coord = batch.coords
        agg = EdgeAggregator(batch.senders, batch.receivers,
                             batch.edge_mask, num_nodes=h.shape[0],
                             recv_perm=batch.recv_perm,
                             inv_recv_perm=batch.inv_recv_perm,
                             axis=self.edge_shard_axis)
        num_graphs = batch.graph_mask.shape[0]
        edge_messages = None
        remat = (self.remat and torch.is_grad_enabled()
                 and aux_layers is None)
        for layer in self.layers[1:]:
            args = (h, coord, edge_messages, agg, batch.edge_attr,
                    batch.edge_mask, batch.node_mask, batch.graph_id,
                    num_graphs)
            with span('pointvs.model.layer'):
                if remat:
                    h, coord, edge_messages = checkpoint(
                        layer, *args, use_reentrant=False)
                elif aux_layers is not None:
                    aux_layers.append({})
                    h, coord, edge_messages = layer(*args,
                                                    aux=aux_layers[-1])
                else:
                    h, coord, edge_messages = layer(*args)
        return h

    def pool(self, h: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        """Masked mean of each graph's node embeddings, with the graph's
        dE appended under ``include_strain_info``. The embeddings are
        rounded to f32 first, as the reference's ``pool`` does under both
        ``--bf16`` and ``--double``; the result is in the parameters'
        dtype, which the head takes."""
        pooled = masked_graph_mean_pool(h.float(), batch.graph_id,
                                        batch.graph_mask.shape[0],
                                        batch.node_mask.float())
        if self.include_strain_info:
            pooled = torch.cat([pooled, batch.strain[:, :1].float()], dim=1)
        return pooled.to(self.layers[0].m.weight.dtype)

    def head(self, pooled: torch.Tensor, task=None) -> torch.Tensor:
        """The output head on the pooled embeddings (one head here; the
        multitask model picks one by ``task``)."""
        del task
        return self.feats_linear_layers(pooled)

    def forward(self, batch: GraphBatch, train: bool = False,
                dropout_seed=None, dropout_rng=None,
                capture_aux: bool = False):
        """Logits; with ``capture_aux``, (logits, aux) where aux holds each
        layer's aux dict (``layers``), ``node_embeddings`` and
        ``pooled``, as the reference's ``capture_aux``."""
        return self._forward(batch, train, dropout_seed, dropout_rng,
                             capture_aux)

    def _forward(self, batch, train, dropout_seed, dropout_rng,
                 capture_aux, task=None):
        layers = [] if capture_aux else None
        h = self.embed(batch, train, dropout_seed, dropout_rng, layers)
        pooled = self.pool(h, batch)
        out = self.head(pooled, task)
        if capture_aux:
            return out, {'layers': layers, 'node_embeddings': h,
                         'pooled': pooled}
        return out
