"""EdgeAggregator: per-edge gathers and edge->node aggregations (forward).

Counterpart of ``pointvs_tpu/ops/aggregate.py``. Conventions as in
``data/buckets.py``: ``senders`` sorted ascending with padding edges equal
to ``num_nodes``. Every aggregation goes through one of the two segment
kernels (``ops/segment_kernels.py``). Clamps use ``torch.maximum`` as the
reference uses ``jnp.maximum``, so that gradients added later split ties
the same way.
"""
from __future__ import annotations

import torch

from pointvs_tpu_torch.ops import segment_kernels
from pointvs_tpu_torch.ops.sorted_segment import (
    gather_by_sorted_ids,
    windowed_segment_max,
    windowed_segment_sum,
)


class EdgeAggregator:
    """Bound to one batch's edge layout; holds no model parameters."""

    def __init__(self, senders: torch.Tensor, receivers: torch.Tensor,
                 edge_mask: torch.Tensor | None, num_nodes: int,
                 inv_recv_perm: torch.Tensor | None = None):
        self.senders = senders
        self.receivers = receivers
        self.edge_mask = edge_mask
        self.num_nodes = num_nodes
        # Present only for verified-symmetric edge lists: then
        # h[receivers] == h[senders][inv_recv_perm].
        self.inv_recv_perm = inv_recv_perm

    # -- gathers ------------------------------------------------------- #
    def gather_src(self, h):
        return gather_by_sorted_ids(h, self.senders, self.num_nodes)

    def gather_dst(self, h):
        return gather_by_sorted_ids(h, self.receivers, self.num_nodes)

    def gather_pair(self, hc):
        """(hc[senders], hc[receivers]) from one node gather."""
        hc_s = self.gather_src(hc)
        return hc_s, hc_s.index_select(0, self.inv_recv_perm)

    # -- aggregations to the SOURCE index (satorras convention) -------- #
    def _mask(self, mask):
        return self.edge_mask if mask is None else mask

    def _masked(self, data, mask):
        mask = self._mask(mask)
        if mask is None:
            return data
        mask = mask.to(data.dtype)
        return data * (mask[:, None] if data.dim() > 1 else mask)

    def sum_to_src(self, data, mask=None):
        return windowed_segment_sum(self._masked(data, mask), self.senders,
                                    self.num_nodes)

    def _fused(self, edge_feat, logits, trans, mask, mode):
        mask = self._mask(mask)
        flat = logits[:, 0] if (logits.dim() == 2
                                and logits.shape[-1] == 1) else logits
        if mask is None:
            mask = torch.ones_like(flat)
        return segment_kernels.fused_softmax_aggregate(
            edge_feat, flat, trans.to(edge_feat.dtype),
            mask.to(edge_feat.dtype), self.senders, self.num_nodes, mode)

    def fused_softmax_aggregate(self, edge_feat, logits, trans, mask=None):
        """(sum_e softmax_e * feat_e, mean_e trans_e) per destination.

        sum softmax*m == (sum expd*m) / (sum expd): the normalised per-edge
        attention is never formed. Division as the reference's ``_fsp_fwd``.
        """
        k = edge_feat.shape[1]
        out, _ = self._fused(edge_feat, logits, trans, mask, 'softmax')
        denom_c = torch.maximum(out[:, k + 4], out.new_tensor(1e-16))
        counts_c = torch.maximum(out[:, k + 5], out.new_tensor(1.0))
        return (out[:, :k] / denom_c[:, None],
                out[:, k:k + 3] / counts_c[:, None])

    def fused_sigmoid_aggregate(self, edge_feat, logits, trans, mask=None):
        """(sum sigmoid(logits)*feat, mean trans) per destination; division
        as the reference's ``_fsg_fwd``."""
        k = edge_feat.shape[1]
        out, _ = self._fused(edge_feat, logits, trans, mask, 'sigmoid')
        counts_c = torch.maximum(out[:, k + 5], out.new_tensor(1.0))
        return out[:, :k], out[:, k:k + 3] / counts_c[:, None]

    def fused_sum_mean_to_src(self, messages, trans, mask=None):
        """(segment_sum(messages), segment_mean(trans)) in one kernel launch
        over the packed [messages | trans | mask] edge array."""
        mask = self._mask(mask)
        ones = (messages.new_ones((messages.shape[0], 1)) if mask is None
                else mask[:, None].to(messages.dtype))
        k = messages.shape[1]
        packed = torch.cat([self._masked(messages, mask),
                            self._masked(trans.to(messages.dtype), mask),
                            ones], dim=1)
        out = windowed_segment_sum(packed, self.senders, self.num_nodes)
        counts = torch.maximum(out[:, k + 3:k + 4], out.new_tensor(1.0))
        return out[:, :k], out[:, k:k + 3] / counts

    def mean_to_src(self, data, mask=None):
        mask = self._mask(mask)
        total = self.sum_to_src(data, mask)
        counts = windowed_segment_sum(mask, self.senders, self.num_nodes)
        denom = torch.maximum(counts, counts.new_tensor(1.0))
        return total / (denom[:, None] if data.dim() > 1 else denom)

    def softmax_src(self, logits, mask=None):
        """Softmax per destination over its edges; masked edges get 0."""
        mask = self._mask(mask)
        squeeze = logits.dim() == 2 and logits.shape[-1] == 1
        flat = logits[:, 0] if squeeze else logits
        guarded = (torch.where(mask > 0, flat, flat.new_tensor(-1e30))
                   if mask is not None else flat)
        seg_max = windowed_segment_max(guarded, self.senders, self.num_nodes)
        seg_max = torch.where(seg_max > -1e29, seg_max, seg_max.new_zeros(()))
        shift = seg_max[self.senders.clamp(max=self.num_nodes - 1)]
        expd = torch.exp(flat - shift)
        if mask is not None:
            expd = expd * mask.to(expd.dtype)
        denom = windowed_segment_sum(expd, self.senders, self.num_nodes)
        denom_e = gather_by_sorted_ids(
            torch.maximum(denom, denom.new_tensor(1e-16)), self.senders,
            self.num_nodes)
        out = expd / torch.where(denom_e == 0, denom_e.new_ones(()), denom_e)
        return out[:, None] if squeeze else out
