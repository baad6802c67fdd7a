"""Graph-sharded (edge-parallel) scoring and training.

Counterpart of ``pointvs_tpu/parallel/graph_shard.py``: one batch's edge
list is split over the ranks of a gp group, the node arrays are
replicated, and every aggregation sums its partial node sums over the
group (``ops/aggregate.py``). For complexes whose edge tensors outgrow
one device, or to cut the latency of one very large graph; batched
screening wants data parallelism instead.

- ``shard_graph_batch``: a padded batch whose edges are split in equal
  slices, each padded with ``senders == receivers == num_nodes`` (edges
  kernel K1 drops), each with its own stable local ``recv_perm`` and no
  ``inv_recv_perm``.
- ``make_sharded_forward`` / ``make_sharded_train_step``: one graph batch
  over the mesh's gp group (n_dp == 1), the step's dropout key folded
  with the gp rank; the gradients are averaged over gp (the reference's
  ``pmean``: each rank's raw gradient of an edge-path parameter is n_gp
  times its partial, and node-path gradients come out replicated).
- ``make_train_step_2d``: the (dp x gp) mesh, each dp row its own
  sub-batch (the loader's, ``data/loader.py``) with its edges split over
  the row's gp ranks; the dropout key is folded with the dp rank (the
  same on the row's gp ranks, whose replicated node state must agree);
  gradients average over gp and sum over dp with ``loss_sum`` and
  ``weight``. The 2-D eval step is ``steps.make_eval_step`` on a rank:
  the model's aggregations sum over gp.

The model is built with ``edge_shard_axis=mesh.edge_axis``. Unlike the
reference, a model needs no unsharded clone to initialise: its parameters
exist before any forward.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np

from pointvs_tpu_torch.data.buckets import GraphBatch, GraphSample, \
    pad_graphs_to_batch
from pointvs_tpu_torch.ops.prng import fold_in
from pointvs_tpu_torch.parallel.mesh import Mesh
from pointvs_tpu_torch.parallel.steps import make_train_step


def split_edges(base: GraphBatch, num_shards: int) -> List[GraphBatch]:
    """A padded batch's edges in ``num_shards`` equal slices, the node and
    graph arrays shared."""
    e_pad, n_pad = base.senders.shape[0], base.node_feats.shape[0]
    per_shard = -(-e_pad // num_shards)
    shards = []
    for d in range(num_shards):
        lo, hi = d * per_shard, min((d + 1) * per_shard, e_pad)
        senders = np.full((per_shard,), n_pad, np.int32)
        receivers = np.full((per_shard,), n_pad, np.int32)
        edge_attr = np.zeros((per_shard,) + base.edge_attr.shape[1:],
                             np.float32)
        edge_mask = np.zeros((per_shard,), np.float32)
        n = max(0, hi - lo)
        senders[:n] = base.senders[lo:hi]
        receivers[:n] = base.receivers[lo:hi]
        edge_attr[:n] = base.edge_attr[lo:hi]
        edge_mask[:n] = base.edge_mask[lo:hi]
        # Slices of sorted senders stay sorted; the receivers get a local
        # stable sort.
        recv_perm = np.argsort(receivers, kind='stable').astype(np.int32)
        shards.append(base._replace(
            senders=senders, receivers=receivers, edge_attr=edge_attr,
            edge_mask=edge_mask, recv_perm=recv_perm, inv_recv_perm=None))
    return shards


def shard_graph_batch(samples, num_shards: int, num_graphs=None,
                      n_pad=None, e_pad=None) -> List[GraphBatch]:
    """GraphSample(s) -> the ``num_shards`` edge shards of their padded
    batch (one sample, the huge-complex use, or a list: one dp row's
    sub-batch)."""
    if isinstance(samples, GraphSample):
        samples = [samples]
    return split_edges(pad_graphs_to_batch(
        samples, num_graphs=num_graphs, n_pad=n_pad, e_pad=e_pad),
        num_shards)


def make_sharded_forward(model, mesh: Mesh, **apply_kwargs) -> Callable:
    """(batch shard on this rank's device) -> logits of the whole graph:
    the aggregations' sums make every rank's output the full result."""
    del mesh   # the model's edge_shard_axis names the group

    def forward(batch):
        model.eval()
        return model(batch, **apply_kwargs)

    return forward


def make_sharded_train_step(model, optimiser, model_task: str,
                            regression_loss: str, mesh: Mesh) -> Callable:
    """``step(batch, lr, key)``: one optimiser step on one graph batch
    whose edges are sharded over the mesh's gp group (n_dp == 1); the
    dropout key is ``fold_in(key, gp_rank)`` (per-edge dropout differs by
    shard, as in the reference)."""
    if mesh.n_dp != 1:
        raise ValueError('make_sharded_train_step takes a gp-only mesh; '
                         'use make_train_step_2d')
    inner = make_train_step(model, optimiser, model_task, regression_loss,
                            mesh=mesh)

    def step(batch, lr: float, key=None):
        rng = None if key is None else fold_in(key, mesh.gp_rank)
        return inner(batch, lr, rng)

    step.allreduce_ms = inner.allreduce_ms
    return step


def make_train_step_2d(model, optimiser, model_task: str,
                       regression_loss: str, mesh: Mesh,
                       multitask: bool = False) -> Callable:
    """``step(batch, lr, key)`` over the (dp x gp) mesh: the dropout key is
    ``fold_in(key, dp_rank)``, the same on every gp rank of the row."""
    inner = make_train_step(model, optimiser, model_task, regression_loss,
                            multitask=multitask, mesh=mesh)

    def step(batch, lr: float, key=None):
        rng = None if key is None else fold_in(key, mesh.dp_rank)
        return inner(batch, lr, rng)

    step.allreduce_ms = inner.allreduce_ms
    return step
