"""Masked per-graph pooling (counterpart of ``pointvs_tpu/ops/segment.py``)."""
from __future__ import annotations

import torch

from pointvs_tpu_torch.ops.sorted_segment import dense_graph_segment_sum


def masked_graph_mean_pool(node_values: torch.Tensor, graph_id: torch.Tensor,
                           num_graphs: int,
                           node_mask: torch.Tensor) -> torch.Tensor:
    """Per-graph mean over real nodes (pyg global_mean_pool equivalent)."""
    total = dense_graph_segment_sum(node_values, graph_id, num_graphs,
                                    mask=node_mask)
    counts = dense_graph_segment_sum(node_mask, graph_id, num_graphs)
    return total / torch.maximum(counts, counts.new_tensor(1.0))[:, None]
