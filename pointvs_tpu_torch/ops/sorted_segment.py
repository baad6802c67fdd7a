"""Segment ops over destination-sorted edge lists, with their gradients.

Counterpart of ``pointvs_tpu/ops/sorted_segment.py``. Ids are sorted
ascending and an id equal to ``num_segments`` marks a padding edge, which
every op drops. The TPU tiling of the reference (node windows, per-window
edge capacity ``max_eb``, the capacity override) has no counterpart here:
the CUDA kernel reduces each destination's edge range directly.

The segment sum and the sorted gather are each other's transpose, as in
the reference's custom VJPs (``_wss_bwd``, ``_gsi_bwd``): the sum's
backward is a row gather by the ids, and the gather's backward is the sum,
so on a GPU every gradient scattered back to the nodes goes through
kernel K1 (deterministic, no atomics). Each op takes the ids' row offsets
(``segment_kernels.segment_offsets``) where its caller has them, so that
K1 finds no offsets of its own.
"""
from __future__ import annotations

import torch

from pointvs_tpu_torch.ops import segment_kernels


def _gather_rows(node_values, ids, num_segments):
    """node_values[ids] with padding ids (== num_segments) giving zeros."""
    clamped = ids.clamp(max=num_segments - 1)
    valid = (ids < num_segments).to(node_values.dtype)
    out = node_values.index_select(0, clamped)
    return out * (valid[:, None] if out.dim() > 1 else valid)


def _segment_sum(data, ids, num_segments, offsets=None):
    squeeze = data.dim() == 1
    out = segment_kernels.windowed_segment_sum(
        data[:, None] if squeeze else data, ids, num_segments, offsets)
    return out[:, 0] if squeeze else out


class _SegmentSum(torch.autograd.Function):
    """Forward K1 (plain on the CPU); backward a row gather (``_wss_bwd``)."""

    @staticmethod
    def forward(ctx, data, sorted_ids, num_segments, offsets):
        ctx.save_for_backward(sorted_ids)
        ctx.num_segments = num_segments
        return _segment_sum(data, sorted_ids, num_segments, offsets)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _gather_rows(g, ids, ctx.num_segments), None, None, None


class _GatherSorted(torch.autograd.Function):
    """Forward a row gather; backward K1 over the same ids (``_gsi_bwd``)."""

    @staticmethod
    def forward(ctx, node_values, sorted_ids, num_segments, offsets):
        ctx.save_for_backward(sorted_ids, offsets)
        ctx.num_segments = num_segments
        return _gather_rows(node_values, sorted_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        ids, offsets = ctx.saved_tensors
        return (_segment_sum(g.contiguous(), ids, ctx.num_segments, offsets),
                None, None, None)


def windowed_segment_sum(data: torch.Tensor, sorted_ids: torch.Tensor,
                         num_segments: int,
                         offsets: torch.Tensor | None = None) -> torch.Tensor:
    """segment_sum(data, sorted_ids) for [E] or [E, K] data."""
    return _SegmentSum.apply(data, sorted_ids, num_segments, offsets)


def gather_by_sorted_ids(node_values: torch.Tensor, sorted_ids: torch.Tensor,
                         num_segments: int,
                         offsets: torch.Tensor | None = None) -> torch.Tensor:
    """node_values[ids] with padding ids giving zero rows."""
    return _GatherSorted.apply(node_values, sorted_ids, num_segments, offsets)


def windowed_segment_max(values: torch.Tensor, sorted_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Per-segment max of a [E] vector; empty segments give -1e30. No
    gradient (the reference stops it: the max only shifts a softmax)."""
    out = values.new_full((num_segments + 1,), -1e30)
    out.scatter_reduce_(0, sorted_ids.long(), values.detach(), 'amax',
                        include_self=True)
    return out[:num_segments]


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
