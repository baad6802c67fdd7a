"""Fused engine: the Satorras EGNN with every layer's edge pass in one
kernel (K3, ``ops/fused_egnn.py``).

Counterpart of ``pointvs_tpu/inference_engine.py`` (``supports_fusion``,
``_layer_attention``, ``fused_forward``; node attention is read by the
layer's own ``node_update``) and
of the layer walk of ``pointvs_tpu/fused_train.py``. It reads the port's
``nn.Module`` parameters (the reference state_dict schema) directly: the
edge MLP, coordinate MLP and attention weights go into the kernel; the
node side (node MLP, GraphNorm, node attention, residual, pooling, head)
is the model's own modules, which the reference also leaves outside its
kernel.

Per layer: gathers through ``EdgeAggregator`` (their backward is K1), the
radial with the detached norm, the edge pass, the coordinate mean, the
node update. The same walk serves serving (``fused_forward``, no
gradient) and training (``fused_train.fused_apply``, through
``FusedEdgePass``, whose backward is K4).

The reference also gates fusion on the TPU's scoped VMEM and runs
``model.apply`` where it would not fit; that function is the same as the
fused one, and a CUDA kernel has no such capacity, so the port has no
such gate. With ``graphnorm_whole_batch`` the port's fused walk keeps the
model's whole-batch statistics (its GraphNorm module), where the
reference's fused walk uses per-graph statistics.
"""
from __future__ import annotations

import torch

from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.models.egnn import EPSILON, SartorrasEGNN
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.ops.fused_egnn import fused_edge_forward, \
    fused_edge_pass
from pointvs_tpu_torch.ops.segment import masked_graph_mean_pool


def supports_fusion(model) -> bool:
    """The reference's model conditions (dropout and bf16 are refused by
    the port's model itself)."""
    return (isinstance(model, SartorrasEGNN)
            and not model.permutation_invariance
            and not (model.edge_residual
                     and (model.rezero or model.gated_residual)))


def _layer_attention(model, i: int) -> str:
    """Attention mode of layer i (0-based EGNN layer index)."""
    layer = model.layers[i + 1]
    if not layer.edge_attention:
        return 'none'
    return ('softmax' if layer.softmax_attention
            else layer.attention_activation_fn)


def _kernel_params(layer, attention: str, like: torch.Tensor) -> dict:
    """The layer's edge-pass weights as views of its parameters."""
    k = like.shape[1]
    zeros = lambda *shape: like.new_zeros(shape)  # noqa: E731
    params = {'w1': layer.edge_mlp[0].weight, 'b1': layer.edge_mlp[0].bias,
              'w2': layer.edge_mlp[2].weight, 'b2': layer.edge_mlp[2].bias}
    if layer.update_coords:
        params.update(cw1=layer.coord_mlp[0].weight,
                      cb1=layer.coord_mlp[0].bias,
                      cw2=layer.coord_mlp[2].weight.view(-1))
    else:   # phi is unused; the kernel still computes it
        params.update(cw1=zeros(k, k), cb1=zeros(k), cw2=zeros(k))
    if attention != 'none':
        params.update(attw=layer.att_mlp[0].weight.view(-1),
                      attb=layer.att_mlp[0].bias)
    else:
        params.update(attw=zeros(k), attb=zeros(1))
    return params


def fused_network(model, batch: GraphBatch, differentiable: bool):
    """The model's output through the fused edge pass in every layer."""
    h = model.layers[0](batch.node_feats)
    coord = batch.coords
    n_pad, k = h.shape
    edge_mask = batch.edge_mask
    num_graphs = batch.graph_mask.shape[0]
    agg = EdgeAggregator(batch.senders, batch.receivers, edge_mask,
                         num_nodes=n_pad, recv_perm=batch.recv_perm)
    prev = None
    for i, layer in enumerate(model.layers[1:]):
        attention = _layer_attention(model, i)
        hc_r = agg.gather_dst(torch.cat([h, coord], dim=1))
        coord_diff = agg.gather_src(coord) - hc_r[:, k:k + 3]
        radial = (coord_diff ** 2).sum(dim=1)
        if layer.normalize:
            # detached norm (ref egnn_satorras.py:183-185)
            coord_diff = coord_diff / (
                torch.sqrt(radial).detach() + EPSILON)[:, None]
        extras = torch.cat([radial[:, None], batch.edge_attr], dim=1)
        params = _kernel_params(layer, attention, h)
        if layer.edge_residual and prev is None:
            prev = torch.zeros_like(hc_r[:, :k])
        edge_prev = prev if layer.edge_residual else None
        if differentiable:
            agg_feats, phi, _, msg = fused_edge_pass(
                h, hc_r[:, :k], extras, edge_prev, params, edge_mask,
                batch.senders, attention, layer.tanh, agg.src_offsets)
        else:
            agg_feats, phi, _, msg = fused_edge_forward(
                h, hc_r[:, :k], extras, edge_mask, batch.senders, edge_prev,
                params, attention, layer.tanh)
        if layer.edge_residual:
            prev = msg
        if layer.update_coords:
            phi = torch.where(edge_mask > 0, phi, phi.new_zeros(()))
            coord = coord + agg.mean_to_src(coord_diff * phi[:, None],
                                            mask=edge_mask)
        h = layer.node_update(h, agg_feats, batch.node_mask, batch.graph_id,
                              num_graphs)
    pooled = masked_graph_mean_pool(h, batch.graph_id, num_graphs,
                                    batch.node_mask)
    return model.feats_linear_layers(pooled)


def _refuse_task(task):
    if task is not None:
        raise NotImplementedError(
            'per-task heads (MultitaskSatorrasEGNN) are not in the port yet '
            '(see ROADMAP.md, Queue 1)')


@torch.no_grad()
def fused_forward(model, batch: GraphBatch, task=None) -> torch.Tensor:
    """Forward equal to ``model(batch)`` with K3 in every layer."""
    _refuse_task(task)
    if not supports_fusion(model):
        return model(batch)
    return fused_network(model, batch, differentiable=False)
