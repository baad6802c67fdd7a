"""EdgeAggregator: per-edge gathers and edge->node aggregations.

Counterpart of ``pointvs_tpu/ops/aggregate.py``. Conventions as in
``data/buckets.py``: ``senders`` sorted ascending with padding edges equal
to ``num_nodes``; ``recv_perm`` sorts ``receivers``. Every aggregation goes
through one of the two segment kernels (``ops/segment_kernels.py``), and
every gather's backward through kernel K1, as the reference's custom VJPs
do (``_gu_bwd``, ``_gp_bwd``); the attention aggregations' backward is
``_fsp_bwd`` / ``_fsg_bwd`` line for line. Clamps use ``torch.maximum``,
whose gradient splits ties 0.5/0.5 like ``jnp.maximum``
(``_max_grad_factor``). The row offsets of ``senders`` are found once, when
the aggregator is built, and those of ``receivers_sorted`` at the first
gather whose backward sums over them; every kernel launch takes them.
"""
from __future__ import annotations

import torch

from pointvs_tpu_torch.ops import segment_kernels
from pointvs_tpu_torch.ops.sorted_segment import (
    _gather_rows,
    _segment_sum,
    gather_by_sorted_ids,
    windowed_segment_max,
    windowed_segment_sum,
)


def _max_grad_factor(x, c):
    """d maximum(x, c) / dx, with the 0.5 tie split."""
    return torch.where(x > c, 1.0, torch.where(x == c, 0.5, 0.0)).to(x.dtype)


class _GatherUnsorted(torch.autograd.Function):
    """node_values[ids] for unsorted ids; backward scatters through the
    sorting permutation with K1 (``_gu_bwd``)."""

    @staticmethod
    def forward(ctx, node_values, ids, perm, sorted_ids, num_segments,
                offsets):
        ctx.save_for_backward(perm, sorted_ids, offsets)
        ctx.num_segments = num_segments
        return _gather_rows(node_values, ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        perm, sorted_ids, offsets = ctx.saved_tensors
        d = _segment_sum(g.index_select(0, perm), sorted_ids,
                         ctx.num_segments, offsets)
        return d, None, None, None, None, None


class _GatherPair(torch.autograd.Function):
    """(hc[senders], hc[receivers]) for a symmetric edge list from one
    gather: hc[receivers] == hc[senders][inv_recv_perm]. Backward: both
    cotangents ride one K1 over the senders (``_gp_bwd``)."""

    @staticmethod
    def forward(ctx, hc, senders, recv_perm, inv_recv_perm, num_segments,
                offsets):
        ctx.save_for_backward(senders, recv_perm, offsets)
        ctx.num_segments = num_segments
        hc_s = _gather_rows(hc, senders, num_segments)
        return hc_s, hc_s.index_select(0, inv_recv_perm)

    @staticmethod
    def backward(ctx, g_s, g_r):
        senders, recv_perm, offsets = ctx.saved_tensors
        g = g_s + g_r.index_select(0, recv_perm)
        return (_segment_sum(g, senders, ctx.num_segments, offsets),
                None, None, None, None, None)


class _FusedSoftmax(torch.autograd.Function):
    """(sum softmax*feat, mean trans) per destination through K2; the
    backward is the reference's ``_fsp_fwd`` / ``_fsp_bwd``."""

    @staticmethod
    def forward(ctx, feat, logits, trans, mask, senders, num_segments,
                offsets):
        k = feat.shape[1]
        out, seg_max = segment_kernels.fused_softmax_aggregate(
            feat, logits, trans, mask, senders, num_segments, 'softmax',
            offsets)
        denom_raw, counts_raw = out[:, k + 4], out[:, k + 5]
        denom_c = torch.maximum(denom_raw, denom_raw.new_tensor(1e-16))
        counts_c = torch.maximum(counts_raw, counts_raw.new_tensor(1.0))
        feat_agg = out[:, :k] / denom_c[:, None]
        coord_mean = out[:, k:k + 3] / counts_c[:, None]
        ctx.save_for_backward(feat, logits, mask, senders, seg_max,
                              denom_raw, counts_c, feat_agg)
        ctx.num_segments = num_segments
        return feat_agg, coord_mean

    @staticmethod
    def backward(ctx, g_f, g_c):
        (feat, logits, mask, senders, seg_max, denom_raw, counts_c,
         feat_agg) = ctx.saved_tensors
        n = ctx.num_segments
        k = feat.shape[1]
        denom_c = torch.maximum(denom_raw, denom_raw.new_tensor(1e-16))
        ds_f = g_f / denom_c[:, None]
        d_denom = (-(g_f * feat_agg).sum(-1) / denom_c
                   * _max_grad_factor(denom_raw, 1e-16))
        ds_t = g_c / counts_c[:, None]
        packed_e = _gather_rows(torch.cat(
            [ds_f, ds_t, seg_max[:, None], d_denom[:, None]], dim=1),
            senders, n)
        valid = (senders < n).to(feat.dtype)
        gfe = packed_e[:, :k]
        expd = torch.exp(logits - packed_e[:, k + 3]) * mask * valid
        d_feat = gfe * expd[:, None]
        d_expd = (gfe * feat).sum(-1) + packed_e[:, k + 4]
        d_logits = d_expd * expd
        d_trans = packed_e[:, k:k + 3] * mask[:, None]
        return d_feat, d_logits, d_trans, None, None, None, None


class _FusedSigmoid(torch.autograd.Function):
    """(sum sigmoid(logits)*feat, mean trans) per destination through K2;
    the backward is the reference's ``_fsg_fwd`` / ``_fsg_bwd``."""

    @staticmethod
    def forward(ctx, feat, logits, trans, mask, senders, num_segments,
                offsets):
        k = feat.shape[1]
        out, _ = segment_kernels.fused_softmax_aggregate(
            feat, logits, trans, mask, senders, num_segments, 'sigmoid',
            offsets)
        counts_c = torch.maximum(out[:, k + 5], out.new_tensor(1.0))
        ctx.save_for_backward(feat, logits, mask, senders, counts_c)
        ctx.num_segments = num_segments
        return out[:, :k], out[:, k:k + 3] / counts_c[:, None]

    @staticmethod
    def backward(ctx, g_f, g_c):
        feat, logits, mask, senders, counts_c = ctx.saved_tensors
        n = ctx.num_segments
        k = feat.shape[1]
        valid = (senders < n).to(feat.dtype)
        sig = torch.sigmoid(logits)
        w = sig * mask * valid
        packed_e = _gather_rows(
            torch.cat([g_f, g_c / counts_c[:, None]], dim=1), senders, n)
        gfe = packed_e[:, :k]
        d_feat = gfe * w[:, None]
        d_logits = (gfe * feat).sum(-1) * w * (1.0 - sig)
        d_trans = packed_e[:, k:k + 3] * mask[:, None]
        return d_feat, d_logits, d_trans, None, None, None, None


class _SegmentMean(torch.autograd.Function):
    """Per-destination mean of masked edge rows, the count clamped >= 1
    (differentiable in the data, not the mask): one K1 over the packed
    [data * mask | mask] (each column summed alone, in edge order). The
    backward gathers the data columns only, as the two-sum form's did:
    PyTorch gathers rows of a multiple of 16 bytes (here K + 1 = 4
    columns) on a CUDA path far slower than 12-byte ones."""

    @staticmethod
    def forward(ctx, data, mask, senders, num_segments, offsets):
        k = data.shape[1]
        out = _segment_sum(torch.cat([data * mask[:, None], mask[:, None]],
                                     dim=1), senders, num_segments, offsets)
        denom = torch.maximum(out[:, k:], out.new_tensor(1.0))
        ctx.save_for_backward(mask, senders, denom)
        ctx.num_segments = num_segments
        return out[:, :k] / denom

    @staticmethod
    def backward(ctx, g):
        mask, senders, denom = ctx.saved_tensors
        d = _gather_rows(g / denom, senders, ctx.num_segments)
        return d * mask[:, None], None, None, None, None


class EdgeAggregator:
    """Bound to one batch's edge layout; holds no model parameters."""

    def __init__(self, senders: torch.Tensor, receivers: torch.Tensor,
                 edge_mask: torch.Tensor | None, num_nodes: int,
                 recv_perm: torch.Tensor | None = None,
                 inv_recv_perm: torch.Tensor | None = None):
        self.senders = senders
        self.receivers = receivers
        self.edge_mask = edge_mask
        self.num_nodes = num_nodes
        if recv_perm is None:
            recv_perm = torch.argsort(receivers, stable=True)
        self.recv_perm = recv_perm.long()
        self.receivers_sorted = receivers.index_select(0, self.recv_perm)
        # Present only for verified-symmetric edge lists: then
        # h[receivers] == h[senders][inv_recv_perm].
        self.inv_recv_perm = inv_recv_perm
        self.src_offsets = segment_kernels.segment_offsets(senders,
                                                           num_nodes)
        self.dst_offsets = None   # receivers_sorted's, found when needed

    # -- gathers ------------------------------------------------------- #
    def gather_src(self, h):
        return gather_by_sorted_ids(h, self.senders, self.num_nodes,
                                    self.src_offsets)

    def gather_dst(self, h):
        offsets = None
        if torch.is_grad_enabled() and h.requires_grad:
            # The backward sums over receivers_sorted.
            if self.dst_offsets is None:
                self.dst_offsets = segment_kernels.segment_offsets(
                    self.receivers_sorted, self.num_nodes)
            offsets = self.dst_offsets
        return _GatherUnsorted.apply(h, self.receivers, self.recv_perm,
                                     self.receivers_sorted, self.num_nodes,
                                     offsets)

    def gather_pair(self, hc):
        """(hc[senders], hc[receivers]) from one node gather."""
        return _GatherPair.apply(hc, self.senders, self.recv_perm,
                                 self.inv_recv_perm, self.num_nodes,
                                 self.src_offsets)

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
                                    self.num_nodes, self.src_offsets)

    def _fused(self, fn, edge_feat, logits, trans, mask):
        mask = self._mask(mask)
        flat = logits[:, 0] if (logits.dim() == 2
                                and logits.shape[-1] == 1) else logits
        if mask is None:
            mask = torch.ones_like(flat)
        return fn.apply(edge_feat, flat, trans.to(edge_feat.dtype),
                        mask.to(edge_feat.dtype), self.senders,
                        self.num_nodes, self.src_offsets)

    def fused_softmax_aggregate(self, edge_feat, logits, trans, mask=None):
        """(sum_e softmax_e * feat_e, mean_e trans_e) per destination.

        sum softmax*m == (sum expd*m) / (sum expd): the normalised per-edge
        attention is never formed. Division as the reference's ``_fsp_fwd``.
        """
        return self._fused(_FusedSoftmax, edge_feat, logits, trans, mask)

    def fused_sigmoid_aggregate(self, edge_feat, logits, trans, mask=None):
        """(sum sigmoid(logits)*feat, mean trans) per destination; division
        as the reference's ``_fsg_fwd``."""
        return self._fused(_FusedSigmoid, edge_feat, logits, trans, mask)

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
        out = windowed_segment_sum(packed, self.senders, self.num_nodes,
                                   self.src_offsets)
        counts = torch.maximum(out[:, k + 3:k + 4], out.new_tensor(1.0))
        return out[:, :k], out[:, k:k + 3] / counts

    def mean_to_src(self, data, mask=None):
        """segment_mean(data) with the count clamped >= 1, in one kernel
        launch (``_SegmentMean``)."""
        mask = self._mask(mask)
        squeeze = data.dim() == 1
        cols = data[:, None] if squeeze else data
        mask = (cols.new_ones(cols.shape[0]) if mask is None
                else mask.to(cols.dtype))
        mean = _SegmentMean.apply(cols, mask, self.senders, self.num_nodes,
                                  self.src_offsets)
        return mean[:, 0] if squeeze else mean

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
        denom = windowed_segment_sum(expd, self.senders, self.num_nodes,
                                     self.src_offsets)
        denom_e = gather_by_sorted_ids(
            torch.maximum(denom, denom.new_tensor(1e-16)), self.senders,
            self.num_nodes, self.src_offsets)
        out = expd / torch.where(denom_e == 0, denom_e.new_ones(()), denom_e)
        return out[:, None] if squeeze else out
