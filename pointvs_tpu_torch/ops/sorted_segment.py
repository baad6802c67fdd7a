"""Segment ops over destination-sorted edge lists (forward contracts).

Counterpart of ``pointvs_tpu/ops/sorted_segment.py``. Ids are sorted
ascending and an id equal to ``num_segments`` marks a padding edge, which
every op drops. The TPU tiling of the reference (node windows, per-window
edge capacity ``max_eb``, the capacity override) has no counterpart here:
the CUDA kernel reduces each destination's edge range directly.
"""
from __future__ import annotations

import torch

from pointvs_tpu_torch.ops import segment_kernels


def windowed_segment_sum(data: torch.Tensor, sorted_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """segment_sum(data, sorted_ids) for [E] or [E, K] data."""
    squeeze = data.dim() == 1
    out = segment_kernels.windowed_segment_sum(
        data[:, None] if squeeze else data, sorted_ids, num_segments)
    return out[:, 0] if squeeze else out


def windowed_segment_max(values: torch.Tensor, sorted_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Per-segment max of a [E] vector; empty segments give -1e30."""
    out = values.new_full((num_segments + 1,), -1e30)
    out.scatter_reduce_(0, sorted_ids.long(), values, 'amax',
                        include_self=True)
    return out[:num_segments]


def gather_by_sorted_ids(node_values: torch.Tensor, sorted_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """node_values[ids] with padding ids giving zero rows."""
    clamped = sorted_ids.clamp(max=num_segments - 1)
    valid = (sorted_ids < num_segments).to(node_values.dtype)
    out = node_values.index_select(0, clamped)
    return out * (valid[:, None] if out.dim() > 1 else valid)


def dense_graph_segment_sum(node_values: torch.Tensor, graph_id: torch.Tensor,
                            num_graphs: int,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-graph sums as a [N, B] one-hot product (B is the batch size);
    padding rows (graph_id == num_graphs) match no graph."""
    squeeze = node_values.dim() == 1
    if squeeze:
        node_values = node_values[:, None]
    onehot = (graph_id[:, None] == torch.arange(
        num_graphs, device=graph_id.device)[None, :]).to(node_values.dtype)
    if mask is not None:
        onehot = onehot * mask[:, None]
    out = onehot.T @ node_values
    return out[:, 0] if squeeze else out
