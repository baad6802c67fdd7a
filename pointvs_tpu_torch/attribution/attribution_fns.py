"""Attribution methods over a trained model (counterpart of
``pointvs_tpu/attribution/attribution_fns.py``).

Every function takes ``fn(model, batch, task=None, **kwargs)``, where
``batch`` is a one-graph ``GraphBatch`` of tensors on the model's device,
and returns numpy scores of the real (unpadded) atoms or edges.

Masking (``atom_masking``, ``bond_masking``): a masked variant zeroes the
masks of its gone atoms and of their edges, which equals deleting them
(they leave the pooling, the GraphNorm statistics and every aggregation).
Variants run ``_CHUNK`` at a time as one module forward over a tiled
batch of ``_CHUNK`` copies of the graph, built on the device
(``_tiled_batch``), so K2 (attention models) or K1 (the attention-free
ones) launch once per layer for a whole chunk. Every chunk is queued
before any result is read back. Padding is selected out, never
multiplied out: the copies' real edges come first, copy by copy, each
copy's ids offset by its nodes, so the senders stay sorted; the padding
edges follow at the sentinel id (all nodes of all copies).

The other methods read the forward's ``capture_aux`` (each layer's
``att_val``, ``intermediate_coords``, ``node_att_val`` and the
``node_embeddings``), which takes the unfused branch of each layer: the
per-edge attention from ``EdgeAggregator.softmax_src`` and the sums
through K1. Families without ``capture_aux`` in the reference (siamese
and the dense family) are refused by name.

``SIGMOID`` (module flag, False): scores through a sigmoid first, as in
the reference; ``_CHUNK``: masked variants a forward.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.stats import rankdata

from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.models.multitask import MultitaskSatorrasEGNN
from pointvs_tpu_torch.models.siamese import SiameseEGNN
from pointvs_tpu_torch.models.vanilla import DenseEGNN

SIGMOID = False
_CHUNK = 32


def refuse_unattributable(model) -> None:
    """Raise ``ValueError`` for a family whose forward has no
    ``capture_aux`` in the reference (its batches are not graphs)."""
    if isinstance(model, (SiameseEGNN, DenseEGNN)):
        raise ValueError(
            f'{type(model).__name__}: attribution takes one graph and the '
            f'forward\'s capture_aux, which this model family does not '
            f'have (in the reference neither)')


def _task_kwargs(model, task) -> dict:
    if task is not None and isinstance(model, MultitaskSatorrasEGNN):
        return {'task': task}
    return {}


def _to_scores(out: torch.Tensor) -> torch.Tensor:
    """[G, dim_out] logits -> [G] scores: the mean of several outputs
    (multi-regression), optionally through a sigmoid."""
    vals = out.mean(dim=-1) if out.shape[-1] > 1 else out[:, 0]
    return torch.sigmoid(vals) if SIGMOID else vals


def _n_real(mask: torch.Tensor) -> int:
    return int(mask.sum().item())


def _tiled_batch(batch: GraphBatch, gone: torch.Tensor) -> GraphBatch:
    """``c = len(gone)`` copies of a one-graph batch as one batch of c
    graphs, copy i without the atoms ``gone[i]`` marks ([c, N] floats)."""
    c, n = gone.shape
    e_pad = batch.senders.shape[0]
    e = _n_real(batch.edge_mask)     # real edges come first
    dev = batch.senders.device
    copy = torch.arange(c, device=dev)
    node_mask = (batch.node_mask[None, :] * (1 - gone)).reshape(-1)
    graph_id = torch.where(batch.node_mask[None, :] > 0, copy[:, None],
                           c).reshape(-1).to(batch.graph_id.dtype)
    senders = (batch.senders[None, :e] + copy[:, None] * n).reshape(-1)
    receivers = (batch.receivers[None, :e] + copy[:, None] * n).reshape(-1)
    flat_gone = gone.reshape(-1)
    keep = 1 - torch.maximum(flat_gone[senders], flat_gone[receivers])
    edge_mask = batch.edge_mask[None, :e].repeat(c, 1).reshape(-1) * keep

    pad = c * (e_pad - e)
    sentinel = torch.full((pad,), c * n, dtype=batch.senders.dtype,
                          device=dev)
    tail = torch.arange(c * e, c * e_pad, dtype=batch.recv_perm.dtype,
                        device=dev)

    def per_copy(perm):
        # A permutation of the real edges, offset per copy; then the
        # padding edges in place (their ids are the largest).
        return torch.cat([(perm[None, :e] + copy[:, None] * e).reshape(-1)
                          .to(perm.dtype), tail])

    edge_attr = batch.edge_attr[:e].repeat(c, 1)
    return GraphBatch(
        node_feats=batch.node_feats.repeat(c, 1),
        coords=batch.coords.repeat(c, 1),
        node_mask=node_mask,
        graph_id=graph_id,
        senders=torch.cat([senders.to(batch.senders.dtype), sentinel]),
        receivers=torch.cat([receivers.to(batch.receivers.dtype),
                             sentinel]),
        edge_attr=torch.cat([edge_attr, edge_attr.new_zeros(
            (pad, edge_attr.shape[1]))]),
        edge_mask=torch.cat([edge_mask, edge_mask.new_zeros(pad)]),
        y=batch.y.new_zeros((c,) + tuple(batch.y.shape[1:])),
        graph_mask=batch.graph_mask.new_ones(c),
        strain=batch.strain[:1].repeat(c, 1),
        recv_perm=per_copy(batch.recv_perm),
        inv_recv_perm=(None if batch.inv_recv_perm is None
                       else per_copy(batch.inv_recv_perm)))


@torch.no_grad()
def _masked_deltas(model, batch: GraphBatch, gone_rows: np.ndarray,
                   task: Optional[str], chunk: int = _CHUNK) -> np.ndarray:
    """original score - the score without the atoms of each row of
    ``gone_rows`` [V, N], ``chunk`` variants a forward."""
    refuse_unattributable(model)
    kwargs = _task_kwargs(model, task)
    original = _to_scores(model(batch, **kwargs))[0]
    v, n = gone_rows.shape
    if not v:
        return np.zeros(0, np.float32)
    rows = torch.zeros((-(-v // chunk) * chunk, n),
                       dtype=batch.node_mask.dtype,
                       device=batch.node_mask.device)
    rows[:v] = torch.from_numpy(gone_rows).to(rows)
    # Every chunk is queued before any result is read.
    pending = [_to_scores(model(_tiled_batch(batch, rows[lo:lo + chunk]),
                                **kwargs))
               for lo in range(0, v, chunk)]
    return (original - torch.cat(pending)[:v]).float().cpu().numpy()


def atom_masking(model, batch: GraphBatch, task: Optional[str] = None,
                 **kwargs) -> np.ndarray:
    """Leave-one-atom-out score deltas, one per real atom."""
    del kwargs
    n_pad = batch.node_mask.shape[0]
    gone_rows = np.eye(n_pad, dtype=np.float32)[:_n_real(batch.node_mask)]
    return _masked_deltas(model, batch, gone_rows, task)


def bond_masking(model, batch: GraphBatch, task: Optional[str] = None,
                 **kwargs) -> np.ndarray:
    """Leave-one-bond-out (both end atoms gone), scored for the
    ligand-receptor edges (class 1) and 0 for the others."""
    del kwargs
    n_pad = batch.node_mask.shape[0]
    e_real = _n_real(batch.edge_mask)
    senders = np.minimum(batch.senders[:e_real].cpu().numpy(), n_pad - 1)
    receivers = np.minimum(batch.receivers[:e_real].cpu().numpy(),
                           n_pad - 1)
    targets = np.flatnonzero(batch.edge_attr[:e_real, 1].cpu().numpy() > 0)
    gone_rows = np.zeros((len(targets), n_pad), np.float32)
    gone_rows[np.arange(len(targets)), senders[targets]] = 1.0
    gone_rows[np.arange(len(targets)), receivers[targets]] = 1.0
    refuse_unattributable(model)
    out = np.zeros(e_real, np.float32)
    if len(targets):
        out[targets] = _masked_deltas(model, batch, gone_rows, task)
    return out


@torch.no_grad()
def _aux(model, batch: GraphBatch, task) -> dict:
    refuse_unattributable(model)
    _, aux = model(batch, capture_aux=True, **_task_kwargs(model, task))
    return aux


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@torch.no_grad()
def cam(model, batch: GraphBatch, task: Optional[str] = None,
        **kwargs) -> np.ndarray:
    """Class activation mapping: each node's embedding through the head
    (linear and pointwise, so this is the pre-pool product); 3-target
    outputs averaged."""
    del kwargs
    feats = _aux(model, batch, task)['node_embeddings']
    if not hasattr(model, 'include_strain_info'):
        # The reference reads the flag of every family (and stops where
        # the model has none).
        raise ValueError(f'cam: {type(model).__name__} has no '
                         f'include_strain_info head, as in the reference')
    dtype = model.layers[0].m.weight.dtype
    if isinstance(model, MultitaskSatorrasEGNN):
        x = model.head(feats.to(dtype), task)
    else:
        feats = feats.float()
        if model.include_strain_info:
            strain = batch.strain[:1, :1].float().expand(feats.shape[0], 1)
            feats = torch.cat([feats, strain], dim=1)
        x = model.head(feats.to(dtype))
    x = _host(x)
    if x.ndim == 2 and x.shape[1] == 3:
        x = x.mean(axis=1)
    return x.reshape(-1)[:_n_real(batch.node_mask)]


def _layers(model, batch, task):
    return _aux(model, batch, task)['layers']


def node_attention(model, batch: GraphBatch, task=None, gnn_layer: int = -1,
                   **kwargs) -> np.ndarray:
    """One layer's node-attention weights as atom scores."""
    del kwargs
    layers = _layers(model, batch, task)
    vals = _host(layers[gnn_layer]['node_att_val']).reshape(-1)
    vals = vals[:_n_real(batch.node_mask)]
    if SIGMOID:
        return np.log(vals / (1 - vals))
    return vals


def edge_attention(model, batch: GraphBatch, task=None, gnn_layer: int = -1,
                   **kwargs) -> np.ndarray:
    """One layer's edge-attention weights as bond scores."""
    del kwargs
    layers = _layers(model, batch, task)
    vals = _host(layers[gnn_layer]['att_val']).reshape(-1)
    return vals[:_n_real(batch.edge_mask)]


def _mean_rank(layers, key: str, n: int) -> np.ndarray:
    """Mean over the first 10 layers that hold ``key`` of each score's
    rank (0-based, ties averaged) within its layer."""
    ranks = []
    for idx, aux in enumerate(layers):
        if key in aux:
            if idx == 10:
                break
            ranks.append(rankdata(_host(aux[key]).reshape(-1)[:n]) - 1)
    return np.mean(np.vstack(ranks).T, axis=1)


def mean_node_attention_rank(model, batch: GraphBatch, task=None,
                             **kwargs) -> np.ndarray:
    """Mean rank of node attention across the layers (up to 10)."""
    del kwargs
    return _mean_rank(_layers(model, batch, task), 'node_att_val',
                      _n_real(batch.node_mask))


def mean_edge_attention_rank(model, batch: GraphBatch, task=None,
                             **kwargs) -> np.ndarray:
    """Mean rank of edge attention across the layers (up to 10)."""
    del kwargs
    return _mean_rank(_layers(model, batch, task), 'att_val',
                      _n_real(batch.edge_mask))


def track_position_changes(model, batch: GraphBatch, task=None,
                           **kwargs) -> np.ndarray:
    """Each atom's displacement from its input position, summed over the
    layers' coordinate updates."""
    del kwargs
    layers = _layers(model, batch, task)
    n = _n_real(batch.node_mask)
    original = _host(batch.coords)[:n]
    moved = [np.sqrt(np.sum((_host(aux['intermediate_coords'])[:n]
                             - original) ** 2, axis=1)) for aux in layers]
    return np.sum(np.vstack(moved).T, axis=1)


def track_bond_lengths(model, batch: GraphBatch, task=None,
                       **kwargs) -> np.ndarray:
    """Each edge's length after the last layer minus before the first."""
    del kwargs
    layers = _layers(model, batch, task)
    e = _n_real(batch.edge_mask)
    senders = batch.senders[:e].cpu().numpy()
    receivers = batch.receivers[:e].cpu().numpy()
    lengths = [np.linalg.norm(coords[senders] - coords[receivers], axis=1)
               for coords in (_host(batch.coords),
                              _host(layers[-1]['intermediate_coords']))]
    return lengths[1] - lengths[0]


ATTRIBUTION_FNS = {
    'atom_masking': atom_masking,
    'masking': atom_masking,
    'bond_masking': bond_masking,
    'cam': cam,
    'class_activation': cam,
    'node_attention': node_attention,
    'edge_attention': edge_attention,
    'attention': node_attention,
    'mean_node_attention_rank': mean_node_attention_rank,
    'mean_edge_attention_rank': mean_edge_attention_rank,
    'displacement': track_position_changes,
    'bond_lengths': track_bond_lengths,
}
