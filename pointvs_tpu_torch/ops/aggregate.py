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
the aggregator is built, and those of ``receivers_sorted`` at their first
use (a gather whose backward sums over them, or a sum to the receivers);
every kernel launch takes them.

Edge-parallel ("graph-sharded") aggregation, the reference's
``axis_name``: with ``axis`` a ``torch.distributed`` process group, the
edge list is this rank's shard of one batch's edges and the node arrays
are replicated over the group. Every aggregation then sums its partial
node sums over the group (``_psum``, an all-reduce whose backward is an
all-reduce, the transpose of ``psum``), and a softmax's per-node max is
an all-reduce MAX without gradient (the reference stops the gradient
through the shift). Sharded, the aggregator ignores ``inv_recv_perm``
(shards break the edge list's symmetry) and never uses K2, as the
reference takes its Pallas path only when ``axis_name`` is None: the
softmax runs masked segment max, all-reduce MAX, exp, the packed
``[expd * m | trans | expd | mask]`` sum through K1 and an all-reduce SUM,
and the sigmoid, sum and mean aggregations each one K1 and one all-reduce.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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
    """Per-node mean of masked edge rows, the count clamped >= 1
    (differentiable in the data, not the mask): one K1 over the packed
    [data * mask | mask] (each column summed alone, in edge order). The
    rows are summed over ``sorted_ids`` after the permutation ``perm``
    (None for the senders, which are already sorted; ``recv_perm`` for
    the receivers); ``ids`` are the edges' own node ids, by which the
    backward gathers. It gathers the data columns only, as the two-sum
    form's did: PyTorch gathers rows of a multiple of 16 bytes (here
    K + 1 = 4 columns) on a CUDA path far slower than 12-byte ones."""

    @staticmethod
    def forward(ctx, data, mask, ids, perm, sorted_ids, num_segments,
                offsets):
        k = data.shape[1]
        packed = torch.cat([data * mask[:, None], mask[:, None]], dim=1)
        if perm is not None:
            packed = packed.index_select(0, perm)
        out = _segment_sum(packed, sorted_ids, num_segments, offsets)
        denom = torch.maximum(out[:, k:], out.new_tensor(1.0))
        ctx.save_for_backward(mask, ids, denom)
        ctx.num_segments = num_segments
        return out[:, :k] / denom

    @staticmethod
    def backward(ctx, g):
        mask, ids, denom = ctx.saved_tensors
        d = _gather_rows(g / denom, ids, ctx.num_segments)
        return d * mask[:, None], None, None, None, None, None, None


class _SegmentSumToDst(torch.autograd.Function):
    """Per-receiver sums of edge rows: K1 over ``receivers_sorted`` after
    the permutation ``recv_perm``; the backward gathers by the receivers
    (the reference's ``sum_to_dst``, whose sum transposes to the gather)."""

    @staticmethod
    def forward(ctx, data, receivers, perm, sorted_ids, num_segments,
                offsets):
        ctx.save_for_backward(receivers)
        ctx.num_segments = num_segments
        return _segment_sum(data.index_select(0, perm), sorted_ids,
                            num_segments, offsets)

    @staticmethod
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        return (_gather_rows(g, receivers, ctx.num_segments), None, None,
                None, None, None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the backward sums the cotangents over the
    group too (``psum`` transposes to ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


class EdgeAggregator:
    """Bound to one batch's edge layout; holds no model parameters. With
    ``axis`` (a process group) the edges are this rank's shard."""

    def __init__(self, senders: torch.Tensor, receivers: torch.Tensor,
                 edge_mask: torch.Tensor | None, num_nodes: int,
                 recv_perm: torch.Tensor | None = None,
                 inv_recv_perm: torch.Tensor | None = None, axis=None):
        self.senders = senders
        self.receivers = receivers
        self.edge_mask = edge_mask
        self.num_nodes = num_nodes
        self.axis = axis
        if recv_perm is None:
            recv_perm = torch.argsort(receivers, stable=True)
        self.recv_perm = recv_perm.long()
        self.receivers_sorted = receivers.index_select(0, self.recv_perm)
        # Present only for verified-symmetric edge lists: then
        # h[receivers] == h[senders][inv_recv_perm]. Shards are not
        # symmetric (an edge's pair may lie on another rank).
        self.inv_recv_perm = inv_recv_perm if axis is None else None
        self.src_offsets = segment_kernels.segment_offsets(senders,
                                                           num_nodes)
        self.dst_offsets = None   # receivers_sorted's, found when needed

    def _psum(self, x):
        return x if self.axis is None else all_reduce_sum(x, self.axis)

    def _pmax(self, x):
        """Per-node max over the group's shards, without gradient."""
        if self.axis is None:
            return x
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.axis)
        return x

    def receiver_offsets(self) -> torch.Tensor:
        """``dst_offsets``, the row offsets of ``receivers_sorted``: found
        at the first use (a gather's backward or a sum to the receivers)
        and kept."""
        if self.dst_offsets is None:
            self.dst_offsets = segment_kernels.segment_offsets(
                self.receivers_sorted, self.num_nodes)
        return self.dst_offsets

    # -- gathers ------------------------------------------------------- #
    def gather_src(self, h):
        return gather_by_sorted_ids(h, self.senders, self.num_nodes,
                                    self.src_offsets)

    def gather_dst(self, h):
        offsets = None
        if torch.is_grad_enabled() and h.requires_grad:
            offsets = self.receiver_offsets()   # the backward sums here
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
        return self._psum(windowed_segment_sum(
            self._masked(data, mask), self.senders, self.num_nodes,
            self.src_offsets))

    def _flat_mask(self, edge_feat, logits, mask):
        """(logits as [E], the edge mask in the features' dtype)."""
        mask = self._mask(mask)
        flat = logits[:, 0] if (logits.dim() == 2
                                and logits.shape[-1] == 1) else logits
        if mask is None:
            mask = torch.ones_like(flat)
        return flat, mask.to(edge_feat.dtype)

    def _fused(self, fn, edge_feat, logits, trans, mask):
        flat, mask = self._flat_mask(edge_feat, logits, mask)
        return fn.apply(edge_feat, flat, trans.to(edge_feat.dtype), mask,
                        self.senders, self.num_nodes, self.src_offsets)

    def fused_softmax_aggregate(self, edge_feat, logits, trans, mask=None):
        """(sum_e softmax_e * feat_e, mean_e trans_e) per destination.

        sum softmax*m == (sum expd*m) / (sum expd): the normalised per-edge
        attention is never formed. Division as the reference's ``_fsp_fwd``.
        Sharded: the reference's composable form, through K1.
        """
        if self.axis is None:
            return self._fused(_FusedSoftmax, edge_feat, logits, trans, mask)
        flat, mask = self._flat_mask(edge_feat, logits, mask)
        k = edge_feat.shape[1]
        guarded = torch.where(mask > 0, flat, flat.new_tensor(-1e30))
        seg_max = self._pmax(windowed_segment_max(guarded, self.senders,
                                                  self.num_nodes))
        seg_max = torch.where(seg_max > -1e29, seg_max, seg_max.new_zeros(()))
        shift = seg_max[self.senders.clamp(max=self.num_nodes - 1)]
        expd = torch.exp(flat - shift) * mask
        packed = torch.cat([edge_feat * expd[:, None],
                            trans.to(edge_feat.dtype) * mask[:, None],
                            expd[:, None], mask[:, None]], dim=1)
        out = self._psum(windowed_segment_sum(
            packed, self.senders, self.num_nodes, self.src_offsets))
        denom = torch.maximum(out[:, k + 3:k + 4], out.new_tensor(1e-16))
        counts = torch.maximum(out[:, k + 4:k + 5], out.new_tensor(1.0))
        return out[:, :k] / denom, out[:, k:k + 3] / counts

    def fused_sigmoid_aggregate(self, edge_feat, logits, trans, mask=None):
        """(sum sigmoid(logits)*feat, mean trans) per destination; division
        as the reference's ``_fsg_fwd``. Sharded: the sigmoid-weighted
        messages through ``fused_sum_mean_to_src`` (one K1)."""
        if self.axis is None:
            return self._fused(_FusedSigmoid, edge_feat, logits, trans, mask)
        flat, _ = self._flat_mask(edge_feat, logits, mask)
        return self.fused_sum_mean_to_src(
            torch.sigmoid(flat)[:, None] * edge_feat, trans, mask=mask)

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
        out = self._psum(windowed_segment_sum(
            packed, self.senders, self.num_nodes, self.src_offsets))
        counts = torch.maximum(out[:, k + 3:k + 4], out.new_tensor(1.0))
        return out[:, :k], out[:, k:k + 3] / counts

    def _mean(self, data, mask, ids, perm, sorted_ids, offsets):
        """segment_mean(data) with the count clamped >= 1, in one kernel
        launch (``_SegmentMean``)."""
        mask = self._mask(mask)
        squeeze = data.dim() == 1
        cols = data[:, None] if squeeze else data
        mask = (cols.new_ones(cols.shape[0]) if mask is None
                else mask.to(cols.dtype))
        if self.axis is None:
            mean = _SegmentMean.apply(cols, mask, ids, perm, sorted_ids,
                                      self.num_nodes, offsets)
        else:
            # The shards' sums and counts are summed before the division.
            k = cols.shape[1]
            packed = torch.cat([cols * mask[:, None], mask[:, None]], dim=1)
            if perm is not None:
                packed = packed.index_select(0, perm)
            out = self._psum(windowed_segment_sum(
                packed, sorted_ids, self.num_nodes, offsets))
            mean = out[:, :k] / torch.maximum(out[:, k:],
                                              out.new_tensor(1.0))
        return mean[:, 0] if squeeze else mean

    def mean_to_src(self, data, mask=None):
        """Per-sender mean of the masked edge rows (one K1 launch)."""
        return self._mean(data, mask, self.senders, None, self.senders,
                          self.src_offsets)

    def softmax_src(self, logits, mask=None):
        """Softmax per destination over its edges; masked edges get 0.

        ``logits`` is [E], [E, 1] or [E, H]: each of the H columns is its
        own softmax (the reference takes one ``softmax_src`` per column),
        and all H share one max and one K1 launch of width H for their
        denominators.
        """
        mask = self._mask(mask)
        flat = logits if logits.dim() == 2 else logits[:, None]
        col_mask = None if mask is None else mask.to(flat.dtype)[:, None]
        guarded = (torch.where(col_mask > 0, flat, flat.new_tensor(-1e30))
                   if mask is not None else flat)
        seg_max = self._pmax(windowed_segment_max(guarded, self.senders,
                                                  self.num_nodes))
        seg_max = torch.where(seg_max > -1e29, seg_max, seg_max.new_zeros(()))
        shift = seg_max[self.senders.clamp(max=self.num_nodes - 1)]
        expd = torch.exp(flat - shift)
        if mask is not None:
            expd = expd * col_mask
        denom = self._psum(windowed_segment_sum(
            expd, self.senders, self.num_nodes, self.src_offsets))
        denom_e = gather_by_sorted_ids(
            torch.maximum(denom, denom.new_tensor(1e-16)), self.senders,
            self.num_nodes, self.src_offsets)
        out = expd / torch.where(denom_e == 0, denom_e.new_ones(()), denom_e)
        return out if logits.dim() == 2 else out[:, 0]

    # -- aggregations to the DESTINATION index (pyg/lucid convention) -- #
    def sum_to_dst(self, data, mask=None):
        """Per-receiver sums of the masked edge rows: one K1 over
        ``receivers_sorted``."""
        squeeze = data.dim() == 1
        data = self._masked(data, mask)
        out = self._psum(_SegmentSumToDst.apply(
            data[:, None] if squeeze else data, self.receivers,
            self.recv_perm, self.receivers_sorted, self.num_nodes,
            self.receiver_offsets()))
        return out[:, 0] if squeeze else out

    def mean_to_dst(self, data, mask=None):
        """Per-receiver mean of the masked edge rows: one K1 launch over
        ``receivers_sorted``."""
        return self._mean(data, mask, self.receivers, self.recv_perm,
                          self.receivers_sorted, self.receiver_offsets())
