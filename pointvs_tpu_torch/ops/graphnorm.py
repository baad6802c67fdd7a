"""Masked GraphNorm (Cai et al. 2021) with pyg's GraphNorm numerics.

Counterpart of ``pointvs_tpu/ops/graphnorm.py``. Per graph g,

    out = weight * (x - alpha * mean_g) / sqrt(var_g + eps) + bias
    var_g = mean_g[(x - alpha * mean_g)^2],  eps = 1e-5

with statistics over real nodes only. ``whole_batch=True`` is the
reference-exact strict mode: one set of statistics over every real node of
the batch. Padding rows come out zero either way.

``batch_axis`` (a ``torch.distributed`` process group, the reference's
mesh axis name) is the data-parallel group the batch is split over: the
whole-batch mode then sums its masked sums and counts over the group, so
that the statistics cover the global batch. The sums are differentiable
all-reduces (``ops.aggregate.all_reduce_sum``), as the reference's
``psum``. It is set by the Trainer and stays out of the model's kwargs.
"""
from __future__ import annotations

import torch
from torch import nn

from pointvs_tpu_torch.ops.aggregate import all_reduce_sum
from pointvs_tpu_torch.ops.sorted_segment import dense_graph_segment_sum


def _masked_graph_mean(x, graph_id, num_graphs, node_mask):
    total = dense_graph_segment_sum(x, graph_id, num_graphs, mask=node_mask)
    counts = dense_graph_segment_sum(node_mask, graph_id, num_graphs)
    return total / torch.maximum(counts, counts.new_tensor(1.0))[:, None]


def broadcast_per_graph(per_graph, graph_id, num_graphs):
    """per_graph[graph_id], zero for padding rows (graph_id == num_graphs)."""
    onehot = (graph_id[:, None] == torch.arange(
        num_graphs, device=graph_id.device)[None, :]).to(per_graph.dtype)
    return onehot @ per_graph


class GraphNorm(nn.Module):
    """Parameters ``weight``, ``bias``, ``mean_scale`` as in pyg."""

    eps = 1e-5

    def __init__(self, features: int, whole_batch: bool = False,
                 batch_axis=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean_scale = nn.Parameter(torch.ones(features))
        self.whole_batch = whole_batch
        self.batch_axis = batch_axis

    def _psum(self, x):
        return (x if self.batch_axis is None
                else all_reduce_sum(x, self.batch_axis))

    def forward(self, x, graph_id, num_graphs: int, node_mask,
                per_graph: bool = False):
        """``per_graph`` takes per-graph statistics whatever
        ``whole_batch`` says (the fused paths' GraphNorm)."""
        if self.whole_batch and not per_graph:
            count = torch.maximum(self._psum(node_mask.sum()),
                                  node_mask.new_tensor(1.0))
            mean = self._psum((x * node_mask[:, None]).sum(0)) / count
            out = x - mean[None, :] * self.mean_scale
            # Padding rows of ``out`` are -mean*mean_scale: mask them out.
            var = self._psum(((out * out) * node_mask[:, None]).sum(0)) \
                / count
            std = torch.sqrt(var + self.eps)[None, :]
        else:
            mean = _masked_graph_mean(x, graph_id, num_graphs, node_mask)
            out = x - broadcast_per_graph(mean, graph_id,
                                          num_graphs) * self.mean_scale
            var = _masked_graph_mean(out * out, graph_id, num_graphs,
                                     node_mask)
            std = torch.sqrt(
                broadcast_per_graph(var, graph_id, num_graphs) + self.eps)
        # Padding rows get all-zero statistics, so x/sqrt(eps) would grow
        # them ~300x per layer until they overflow and poison real rows
        # through masked (0 * inf) products; zero them instead.
        return torch.where(node_mask[:, None] > 0,
                           self.weight * out / std + self.bias,
                           out.new_zeros(()))
