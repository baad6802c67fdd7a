"""Fused engine: the Satorras EGNN with every layer's edge pass in one
kernel (K3, ``ops/fused_egnn.py``).

Counterpart of ``pointvs_tpu/inference_engine.py`` (``supports_fusion``,
``_layer_attention``, ``fused_forward``) and of the layer walk of
``pointvs_tpu/fused_train.py``. Each layer's attention mode is read from
the layer itself, so the multitask model's first-only and final-only
switches (``models/multitask._apply_switch``) give each layer its own mode
in K3, and its node attention is read by the layer's own ``node_update``;
the head is the model's ``head(pooled, task)``. It reads the port's
``nn.Module`` parameters (the reference state_dict schema) directly: the
edge MLP, coordinate MLP and attention weights go into the kernel; the
node side (node MLP, GraphNorm, node attention, residual, pooling with
the strain input, head) is the model's own modules, which the reference
also leaves outside its kernel.

Per layer: gathers through ``EdgeAggregator`` (their backward is K1), the
radial with the detached norm, the edge pass, the coordinate mean, the
node update. The same walk serves serving (``fused_forward``, no
gradient) and training (``fused_train.fused_apply``, through
``FusedEdgePass``, whose backward is K4).

The reference also gates fusion on the TPU's scoped VMEM and runs
``model.apply`` where it would not fit; that function is the same as the
fused one, and a CUDA kernel has no such capacity, so the port has no
such gate. GraphNorm takes per-graph statistics on this walk, also under
``graphnorm_whole_batch``, as the reference's fused walk does
(``pointvs_tpu/inference_engine.py:196-209``, ``fused_train.py:150-163``);
the module path takes the whole batch's.
"""
from __future__ import annotations

import torch

from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.models.egnn import EPSILON, SartorrasEGNN
from pointvs_tpu_torch.models.multitask import MultitaskSatorrasEGNN
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.ops.fused_egnn import fused_edge_forward, \
    fused_edge_pass


def supports_fusion(model) -> bool:
    """The reference's model conditions, ``not model.bf16`` among them (K3
    and K4 are f32 kernels); the multitask model is a ``SartorrasEGNN``.
    A float64 (``--double``) model is not fused either: the reference
    fuses only on a TPU, which has no float64, and K3/K4 take f32."""
    return (isinstance(model, SartorrasEGNN)
            and not model.bf16
            and model.layers[0].m.weight.dtype == torch.float32
            and not model.permutation_invariance
            and model.dropout == 0
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


def _task_kwargs(model, task) -> dict:
    """``task`` for a multitask model's forward (the reference passes it
    only to that family, and only when given)."""
    return {'task': task} if isinstance(model, MultitaskSatorrasEGNN) \
        and task else {}


def fused_network(model, batch: GraphBatch, differentiable: bool,
                  task=None):
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
                              num_graphs, per_graph_norm=True)
    return model.head(model.pool(h, batch), task)


@torch.no_grad()
def fused_forward(model, batch: GraphBatch, task=None) -> torch.Tensor:
    """Forward equal to ``model(batch[, task=task])`` with K3 in every
    layer; the multitask model's head is the one ``task`` names (pose when
    it is None or holds 'classification')."""
    if not supports_fusion(model):
        return model(batch, **_task_kwargs(model, task))
    return fused_network(model, batch, differentiable=False, task=task)
