"""The compact wire form of a ``GraphBatch`` (counterpart of
``pointvs_tpu/data/wire.py``): host-side compression into one uint8
buffer, one host-to-device copy, and the decode on the device as the
first operation of a step.

Host side (numpy; every field and every packed byte equal to the JAX
package's for the same batch):

- ``WireBatch`` (v1): node features bit-packed along the node axis,
  coordinates, nodes-per-graph counts (or, where ``graph_id`` is not
  non-decreasing, the legacy [N] uint16 ids), uint16 senders and
  receivers (int32 from 65536 padded nodes on), the edge classes in two
  bits an edge (3 = padding; the legacy [E] uint8 ids when ``e_pad`` is
  not a multiple of 4), ``y``, ``graph_mask`` and ``strain``.
- ``WireBatchV2``: per-node out-degrees and per-edge receiver deltas in
  place of the index arrays, for sender-sorted batches.
- ``WireBatchV3``: of a verified symmetric edge list only the half with
  sender < receiver (``native.build.native_symhalf``).
- ``compress`` picks the reference's format: v2 where ``n_pad >= 65536``
  (or ``prefer_v2``) and its invariants hold, else v3 where
  ``POINTVS_WIRE_V3`` (default ``'1'``) allows it and the batch is
  eligible, else v1. ``pack`` lays the fields' bytes end to end in field
  order with no padding (so a field may start at an odd offset);
  ``pack_stacked`` does the same row by row for a [D, ...]-stacked batch.
  ``template`` / ``stacked_template`` give the fields' shapes and numpy
  dtype strings, which the decode reads; they never leave the host.

Device side (torch): ``upload`` copies packed bytes to a device: to a GPU
from pinned memory on a side stream, recording an event that
``ready`` makes the consuming stream wait on. ``unpack`` views the fields
out of the bytes (a field at an offset its dtype cannot be viewed at is
copied first; uint16 fields become int32), and ``decompress`` rebuilds the
``GraphBatch``: the one-hot features and edge classes, the masks from the
padding ids, ``graph_id`` and v2's senders from their counts by a search
over the running sums, ``recv_perm`` by a stable sort of the receivers,
and ``inv_recv_perm`` only for a batch the host verified symmetric
(``symmetric``, a host fact passed as a Python bool: the models branch on
``inv_recv_perm is None``). v3 rebuilds the full edge list by one stable
sort of the mirrored halves, which reproduces the collator's order, and
its ``recv_perm`` is its own inverse. ``decode`` is ``unpack`` then
``decompress``. The decode is plain torch operations, as the reference's
is plain XLA operations outside any Pallas kernel.
"""
from __future__ import annotations

import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from pointvs_tpu_torch.data.buckets import GraphBatch


class WireBatch(NamedTuple):
    node_feats_bits: np.ndarray  # [F, N/8] uint8, little-endian bits
    coords: np.ndarray           # [N, 3] float32
    graph_rle: np.ndarray        # [B+1] int32 nodes per graph (padding
    #                              last), or the legacy [N] uint16 ids
    senders: np.ndarray          # [E] uint16, or int32 from N = 65536
    receivers: np.ndarray        # [E] uint16 or int32
    edge_class: np.ndarray       # [E/4] uint8, 2 bits an edge (3 =
    #                              padding), or the legacy [E] uint8
    y: np.ndarray                # [B] or [B, 3] float32
    graph_mask: np.ndarray       # [B] float32
    strain: np.ndarray           # [B, 2] float32


class WireBatchV2(NamedTuple):
    node_feats_bits: np.ndarray  # [F, N/8] uint8
    coords: np.ndarray           # [N, 3] float32
    graph_counts: np.ndarray     # [B+1] int32
    degrees: np.ndarray          # [N] uint16 out-degree of each node
    recv_delta: np.ndarray       # [E] int16 receiver - sender
    edge_class_bits: np.ndarray  # [E/4] uint8
    y: np.ndarray
    graph_mask: np.ndarray
    strain: np.ndarray


class WireBatchV3(NamedTuple):
    node_feats_bits: np.ndarray  # [F, N/8] uint8
    coords: np.ndarray           # [N, 3] float32
    graph_rle: np.ndarray        # [B+1] int32
    half_senders: np.ndarray     # [E/2] uint16 (padding = N)
    half_receivers: np.ndarray   # [E/2] uint16
    edge_class: np.ndarray       # [E/8] uint8, 2 bits a half edge
    y: np.ndarray
    graph_mask: np.ndarray
    strain: np.ndarray


class Field(NamedTuple):
    """A wire field's shape and numpy dtype string (``'<u2'``, ...)."""
    shape: tuple
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) \
            * np.dtype(self.dtype).itemsize


# ------------------------------------------------------------- host side
def _pack_feature_bits(node_feats) -> np.ndarray:
    feats = np.asarray(node_feats)
    if feats.max(initial=0) > 1 or feats.min(initial=0) < 0:
        raise ValueError('the wire form bit-packs node features, which '
                         'must be 0 or 1')
    # [.., N, F] -> [.., F, N], bit-packed along N (a multiple of 8).
    return np.packbits(feats.astype(np.uint8).swapaxes(-1, -2), axis=-1,
                       bitorder='little')


def _edge_class(batch) -> np.ndarray:
    """[.., E] uint8: each real edge's class (its one-hot's argmax), 3 on
    padding edges."""
    ec = np.argmax(batch.edge_attr, axis=-1).astype(np.uint8)
    return np.where(np.asarray(batch.edge_mask) > 0, ec, np.uint8(3))


def _pack_edge_class_bits(ec: np.ndarray) -> np.ndarray:
    """[.., E] class ids 0-3 -> [.., E/4] uint8, lowest bits first."""
    e4 = ec.reshape(ec.shape[:-1] + (ec.shape[-1] // 4, 4))
    return (e4[..., 0] | (e4[..., 1] << 2) | (e4[..., 2] << 4)
            | (e4[..., 3] << 6)).astype(np.uint8)


def _graph_node_counts(batch) -> Optional[np.ndarray]:
    """[.., B+1] int32 nodes per graph slot (padding nodes last), or None
    where ``graph_id`` is not non-decreasing."""
    graph_id = np.asarray(batch.graph_id, np.int64)
    n_pad = graph_id.shape[-1]
    num_graphs = batch.graph_mask.shape[-1]
    if not np.all(graph_id[..., 1:] >= graph_id[..., :-1]):
        return None
    rows = graph_id.reshape(-1, n_pad)
    counts = np.empty((rows.shape[0], num_graphs + 1), np.int32)
    for d, row in enumerate(rows):
        counts[d] = np.bincount(np.minimum(row, num_graphs),
                                minlength=num_graphs + 1)
    return counts.reshape(graph_id.shape[:-1] + (num_graphs + 1,))


def _floats(batch):
    return dict(y=np.asarray(batch.y, np.float32),
                graph_mask=np.asarray(batch.graph_mask, np.float32),
                strain=np.asarray(batch.strain, np.float32))


def _try_compress_v2(batch) -> Optional[WireBatchV2]:
    """The v2 form where the collator's invariants hold (sorted senders
    and graph ids, receiver deltas within int16, out-degrees within
    uint16), else None."""
    n_pad = batch.node_feats.shape[-2]
    e_pad = batch.senders.shape[-1]
    num_graphs = batch.graph_mask.shape[-1]
    if n_pad % 8 or e_pad % 4:
        return None
    senders = np.asarray(batch.senders, np.int64)
    receivers = np.asarray(batch.receivers, np.int64)
    graph_id = np.asarray(batch.graph_id, np.int64)
    if not (np.all(senders[..., 1:] >= senders[..., :-1])
            and np.all(graph_id[..., 1:] >= graph_id[..., :-1])):
        return None
    delta = receivers - senders
    if delta.size and max(-delta.min(), delta.max()) > 32767:
        return None
    lead = senders.shape[:-1]
    s_rows = senders.reshape(-1, e_pad)
    g_rows = graph_id.reshape(-1, n_pad)
    degrees = np.empty((s_rows.shape[0], n_pad), np.uint16)
    counts = np.empty((g_rows.shape[0], num_graphs + 1), np.int32)
    for d in range(s_rows.shape[0]):
        deg = np.bincount(s_rows[d], minlength=n_pad + 1)[:n_pad]
        if deg.max(initial=0) > 65535:
            return None
        degrees[d] = deg
        counts[d] = np.bincount(np.minimum(g_rows[d], num_graphs),
                                minlength=num_graphs + 1)
    return WireBatchV2(
        node_feats_bits=_pack_feature_bits(batch.node_feats),
        coords=np.asarray(batch.coords, np.float32),
        graph_counts=counts.reshape(lead + (num_graphs + 1,)),
        degrees=degrees.reshape(lead + (n_pad,)),
        recv_delta=delta.astype(np.int16),
        edge_class_bits=_pack_edge_class_bits(_edge_class(batch)),
        **_floats(batch))


def _symhalf_numpy(s, r, rp, ec, n_pad: int):
    """Plain version of ``native_symhalf`` for one edge list: (half
    senders, half receivers, half class bits), or None when the list is
    ineligible for v3. Eligible: (sender, receiver) in lexicographic
    order; ``s[rp] == r`` (with the collator's ``r[rp] == s``, every
    edge's mirror is where ``recv_perm`` puts it); every edge padding
    (``s == r == n_pad``) or with ``s != r`` below ``n_pad``; as many
    edges with ``s < r`` as with ``s > r``; ``E % 8 == 0``.
    """
    e = len(s)
    if e % 8 or not 0 <= n_pad <= 65535:
        return None
    s64 = np.asarray(s, np.int64)
    r64 = np.asarray(r, np.int64)
    rp64 = np.asarray(rp, np.int64)
    if len(rp64) and (rp64.min() < 0 or rp64.max() >= e):
        return None
    if not np.array_equal(s64[rp64], r64):
        return None
    if not np.all((s64[1:] > s64[:-1])
                  | ((s64[1:] == s64[:-1]) & (r64[1:] >= r64[:-1]))):
        return None
    pad = (s64 == n_pad) & (r64 == n_pad)
    real = ~pad
    if np.any(real & ((s64 < 0) | (r64 < 0) | (s64 >= n_pad)
                      | (r64 >= n_pad) | (s64 == r64))):
        return None
    up = real & (s64 < r64)
    n_up = int(up.sum())
    if 2 * n_up != int(real.sum()):
        return None
    half = e // 2
    hs = np.full(half, n_pad, np.uint16)
    hr = np.full(half, n_pad, np.uint16)
    hc = np.full(half, 3, np.uint8)
    hs[:n_up] = s64[up]
    hr[:n_up] = r64[up]
    hc[:n_up] = np.asarray(ec)[up]
    return hs, hr, _pack_edge_class_bits(hc)


def _try_compress_v3(batch) -> Optional[WireBatchV3]:
    """The v3 form of a batch the collator flagged symmetric
    (``inv_recv_perm`` present) with ``n_pad < 65536``, ``E % 8 == 0``,
    non-decreasing graph ids and every edge list eligible
    (``native_symhalf``), else None."""
    from pointvs_tpu_torch.native.build import native_symhalf
    if getattr(batch, 'inv_recv_perm', None) is None:
        return None
    n_pad = batch.node_feats.shape[-2]
    e_pad = batch.senders.shape[-1]
    if n_pad >= 65536 or e_pad % 8 or e_pad == 0:
        return None
    counts = _graph_node_counts(batch)
    if counts is None:
        return None
    s = np.asarray(batch.senders)
    lead = s.shape[:-1]
    rows = [a.reshape(-1, e_pad) for a in (
        s, np.asarray(batch.receivers), np.asarray(batch.recv_perm),
        _edge_class(batch))]
    half = e_pad // 2
    hs = np.empty((rows[0].shape[0], half), np.uint16)
    hr = np.empty_like(hs)
    hb = np.empty((rows[0].shape[0], half // 4), np.uint8)
    for d in range(rows[0].shape[0]):
        out = native_symhalf(*(a[d] for a in rows), n_pad)
        if out is None:
            return None
        hs[d], hr[d], hb[d] = out
    return WireBatchV3(
        node_feats_bits=_pack_feature_bits(batch.node_feats),
        coords=np.asarray(batch.coords, np.float32),
        graph_rle=counts,
        half_senders=hs.reshape(lead + (half,)),
        half_receivers=hr.reshape(lead + (half,)),
        edge_class=hb.reshape(lead + (half // 4,)),
        **_floats(batch))


def compress(batch, prefer_v2: Optional[bool] = None):
    """A host ``GraphBatch`` (optionally with leading axes) in its wire
    form: v2 where ``prefer_v2`` (by default: ``n_pad >= 65536``, where
    v1's indices would be int32) and the batch allows it, else v3 where
    ``POINTVS_WIRE_V3`` (default ``'1'``) is ``'1'`` and the batch is
    eligible, else v1. ``recv_perm`` is never sent: the decode sorts the
    receivers again."""
    n_pad = batch.node_feats.shape[-2]
    if prefer_v2 is None:
        prefer_v2 = n_pad >= 65536
    if prefer_v2:
        v2 = _try_compress_v2(batch)
        if v2 is not None:
            return v2
    if os.environ.get('POINTVS_WIRE_V3', '1') == '1':
        v3 = _try_compress_v3(batch)
        if v3 is not None:
            return v3
    e_pad = batch.senders.shape[-1]
    idx_t = np.uint16 if n_pad < 65536 else np.int32
    counts = _graph_node_counts(batch)
    if counts is None:   # the legacy ids
        counts = np.minimum(np.asarray(batch.graph_id), 65535
                            ).astype(np.uint16)
    ec = _edge_class(batch)
    if e_pad % 4 == 0 and e_pad // 4 != e_pad:
        ec = _pack_edge_class_bits(ec)
    return WireBatch(
        node_feats_bits=_pack_feature_bits(batch.node_feats),
        coords=np.asarray(batch.coords, np.float32),
        graph_rle=counts,
        senders=np.asarray(batch.senders).astype(idx_t),
        receivers=np.asarray(batch.receivers).astype(idx_t),
        edge_class=ec, **_floats(batch))


def carries_exactly(batch) -> bool:
    """Whether the wire form decodes the host ``batch`` to itself bit for
    bit: node features all 0 or 1, each real edge's attributes one-hot and
    each padding edge's zero, ``edge_mask`` 1 exactly where ``senders <
    n_pad`` and ``node_mask`` 1 exactly where ``graph_id`` names a slot.
    The collators' batches always are; ``compress`` refuses other node
    features and would turn other edge attributes into one-hot ones."""
    feats = np.asarray(batch.node_feats)
    if not np.all((feats == 0) | (feats == 1)):
        return False
    n_pad = feats.shape[-2]
    real = np.asarray(batch.senders) < n_pad
    if not np.array_equal(np.asarray(batch.edge_mask), real.astype(
            np.float32)):
        return False
    if not np.array_equal(np.asarray(batch.node_mask), (
            np.asarray(batch.graph_id) < batch.graph_mask.shape[-1]).astype(
            np.float32)):
        return False
    attr = np.asarray(batch.edge_attr)
    hot = attr == 1
    return bool(np.all(hot | (attr == 0))
                and np.array_equal(hot.sum(-1), real.astype(hot.sum(
                    -1).dtype)))


def pack(wire, out: Optional[np.ndarray] = None) -> np.ndarray:
    """The wire batch as one uint8 buffer: each field's bytes in field
    order, end to end (into ``out`` where given)."""
    parts = [np.ascontiguousarray(a).view(np.uint8).reshape(-1)
             for a in wire]
    return np.concatenate(parts, out=out)


def pack_stacked(wire) -> np.ndarray:
    """A [D, ...]-stacked wire batch as [D, nbytes], row by row."""
    parts = [np.ascontiguousarray(a).view(np.uint8).reshape(a.shape[0], -1)
             for a in wire]
    return np.concatenate(parts, axis=1)


def template(wire):
    """The wire batch's fields as ``Field(shape, dtype)``, in its class."""
    return type(wire)(*[Field(tuple(a.shape), np.dtype(a.dtype).str)
                        for a in wire])


def stacked_template(wire):
    """One row's template of a [D, ...]-stacked wire batch."""
    return type(wire)(*[Field(tuple(a.shape[1:]), np.dtype(a.dtype).str)
                        for a in wire])


def nbytes(tmpl) -> int:
    """Bytes of one packed batch of template ``tmpl``."""
    return sum(f.nbytes for f in tmpl)


def num_graphs(tmpl) -> int:
    """Graph slots of a batch of template ``tmpl``."""
    return tmpl.graph_mask.shape[-1]


# ------------------------------------------------------------- transfer
class Staged(NamedTuple):
    """Bytes on a device and the event recorded after their copy on a side
    stream (None where the copy was ordered on the consumer's stream)."""
    data: torch.Tensor
    event: Optional[object] = None


_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def _side_stream(device: torch.device):
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _STREAMS_LOCK:
        if index not in _STREAMS:
            _STREAMS[index] = torch.cuda.Stream(device=index)
        return _STREAMS[index]


def upload(host, device: torch.device) -> Staged:
    """Packed bytes on ``device``: ``host`` an [nbytes] uint8 array, or a
    list of G of them, sent as one [G, nbytes] group. To a GPU: into a
    pinned buffer from the caching host allocator (which keeps the block
    until the copy that reads it has completed), then one non-blocking
    copy on a side stream, after which an event is recorded; ``ready``
    makes the consuming stream wait on it."""
    rows = isinstance(host, (list, tuple))
    if device.type != 'cuda':
        host = np.stack(host) if rows else np.ascontiguousarray(host)
        return Staged(torch.from_numpy(host).to(device))
    shape = (len(host),) + host[0].shape if rows else host.shape
    pinned = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    if rows:
        np.stack(host, out=pinned.numpy())
    else:
        pinned.numpy()[...] = host
    return _copy_on_side_stream(pinned, device)


def upload_pack(wire, device: torch.device) -> Staged:
    """``upload(pack(wire), device)``, packing straight into the pinned
    buffer on a GPU."""
    if device.type != 'cuda':
        return upload(pack(wire), device)
    pinned = torch.empty(nbytes(template(wire)), dtype=torch.uint8,
                         pin_memory=True)
    pack(wire, out=pinned.numpy())
    return _copy_on_side_stream(pinned, device)


def _copy_on_side_stream(pinned: torch.Tensor, device) -> Staged:
    stream = _side_stream(device)
    with torch.cuda.stream(stream):
        data = pinned.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return Staged(data, event)


def ready(buf) -> torch.Tensor:
    """The device bytes of ``buf`` (a ``Staged`` or a tensor), safe to
    read on the current stream: it waits on the copy's event, and the
    bytes are marked as used by the current stream so that the allocator
    does not hand their block out again before its work on them is
    done."""
    if not isinstance(buf, Staged):
        return buf
    if buf.event is not None:
        stream = torch.cuda.current_stream(buf.data.device)
        stream.wait_event(buf.event)
        buf.data.record_stream(stream)
    return buf.data


# ------------------------------------------------------------ device side
def _view(chunk: torch.Tensor, dtype: str) -> torch.Tensor:
    """The bytes of ``chunk`` as numpy dtype ``dtype``; uint16 as int32."""
    np_dtype = np.dtype(dtype)
    if np_dtype == np.uint8:
        return chunk
    if chunk.storage_offset() % np_dtype.itemsize:
        chunk = chunk.clone()   # a field at an odd offset: copy it first
    if np_dtype == np.uint16:
        return chunk.view(torch.int16).to(torch.int32) & 0xFFFF
    return chunk.view({np.dtype(np.int16): torch.int16,
                       np.dtype(np.int32): torch.int32,
                       np.dtype(np.float32): torch.float32}[np_dtype])


def unpack(buf: torch.Tensor, tmpl):
    """[nbytes] uint8 tensor -> the wire batch of tensors ``tmpl``
    describes (uint16 fields as int32)."""
    fields, offset = [], 0
    for f in tmpl:
        n = f.nbytes
        fields.append(_view(buf[offset:offset + n], f.dtype).reshape(
            f.shape))
        offset += n
    if offset != buf.shape[-1]:
        raise ValueError(f'{buf.shape[-1]} bytes for a template of '
                         f'{offset}')
    return type(tmpl)(*fields)


def _feature_bits(bits: torch.Tensor, n_pad: int) -> torch.Tensor:
    """[F, N/8] little-endian bits -> [N, F] float32."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    b = (bits.unsqueeze(-1) >> shifts) & 1
    return b.reshape(bits.shape[0], n_pad).t().to(
        torch.float32).contiguous()


def _class_bits(bits: torch.Tensor, e: int) -> torch.Tensor:
    """[E/4] uint8 -> [E] class ids (two bits each, lowest first)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=bits.device)
    return ((bits.unsqueeze(-1) >> shifts) & 3).reshape(e)


def _one_hot3(ec: torch.Tensor) -> torch.Tensor:
    classes = torch.arange(3, dtype=ec.dtype, device=ec.device)
    return (ec.unsqueeze(-1) == classes).to(torch.float32)


def _ids_from_counts(counts: torch.Tensor, total: int) -> torch.Tensor:
    """The sorted ids that run-length ``counts`` encode: id[i] is the
    index of the first running sum above i (past the last: len(counts))."""
    bounds = torch.cumsum(counts.to(torch.int32), 0, dtype=torch.int32)
    return torch.searchsorted(
        bounds, torch.arange(total, dtype=torch.int32, device=counts.device),
        right=True, out_int32=True)


def _stable_argsort(ids: torch.Tensor) -> torch.Tensor:
    return torch.sort(ids, stable=True).indices.to(torch.int32)


def _maybe_inv(recv_perm: torch.Tensor, symmetric: bool):
    """``inv_recv_perm`` for a batch the host verified symmetric, else
    None: the inverse of the permutation ``recv_perm``."""
    if not symmetric:
        return None
    inv = torch.empty_like(recv_perm)
    inv[recv_perm.long()] = torch.arange(
        recv_perm.shape[0], dtype=torch.int32, device=recv_perm.device)
    return inv


def _batch(wire, node_feats, graph_id, senders, receivers, ec, recv_perm,
           inv_recv_perm) -> GraphBatch:
    n_pad = wire.coords.shape[0]
    return GraphBatch(
        node_feats=node_feats, coords=wire.coords,
        node_mask=(graph_id < wire.graph_mask.shape[0]).to(torch.float32),
        graph_id=graph_id, senders=senders, receivers=receivers,
        edge_attr=_one_hot3(ec),
        edge_mask=(senders < n_pad).to(torch.float32),
        y=wire.y, graph_mask=wire.graph_mask, strain=wire.strain,
        recv_perm=recv_perm, inv_recv_perm=inv_recv_perm)


def decompress(wire, symmetric: bool = False,
               legacy_ids: Optional[bool] = None) -> GraphBatch:
    """An unpacked wire batch -> ``GraphBatch`` on its device.
    ``symmetric`` (a Python bool) says whether the host batch had
    ``inv_recv_perm``. ``legacy_ids`` says whether a v1 ``graph_rle``
    holds [N] ids (the template's uint16) rather than [B+1] counts; by
    default its length decides."""
    n_pad = wire.coords.shape[0]
    feats = _feature_bits(wire.node_feats_bits, n_pad)
    if isinstance(wire, WireBatchV3):
        half = wire.half_senders.shape[0]
        hs, hr = wire.half_senders, wire.half_receivers
        all_s = torch.cat([hr, hs])   # the mirrors first
        all_r = torch.cat([hs, hr])
        perm = torch.sort(all_s, stable=True).indices
        hc = _class_bits(wire.edge_class, half)
        receivers = all_r[perm]
        recv_perm = _stable_argsort(receivers)
        # Each edge's mirror is where recv_perm puts it (verified on the
        # host), so recv_perm is an involution: its own inverse.
        return _batch(wire, feats, _ids_from_counts(wire.graph_rle, n_pad),
                      all_s[perm], receivers, torch.cat([hc, hc])[perm],
                      recv_perm, recv_perm)
    if isinstance(wire, WireBatchV2):
        e_pad = wire.recv_delta.shape[0]
        senders = _ids_from_counts(wire.degrees, e_pad)
        receivers = senders + wire.recv_delta.to(torch.int32)
        recv_perm = _stable_argsort(receivers)
        return _batch(wire, feats, _ids_from_counts(wire.graph_counts,
                                                    n_pad),
                      senders, receivers,
                      _class_bits(wire.edge_class_bits, e_pad), recv_perm,
                      _maybe_inv(recv_perm, symmetric))
    e_pad = wire.senders.shape[0]
    num_slots = wire.graph_mask.shape[0]
    if legacy_ids is None:
        legacy_ids = wire.graph_rle.shape[0] != num_slots + 1
    graph_id = (wire.graph_rle.to(torch.int32) if legacy_ids
                else _ids_from_counts(wire.graph_rle, n_pad))
    ec = (wire.edge_class if wire.edge_class.shape[0] == e_pad
          else _class_bits(wire.edge_class, e_pad))
    senders = wire.senders.to(torch.int32)
    receivers = wire.receivers.to(torch.int32)
    recv_perm = _stable_argsort(receivers)
    return _batch(wire, feats, graph_id, senders, receivers, ec, recv_perm,
                  _maybe_inv(recv_perm, symmetric))


def decode(buf, tmpl, symmetric: bool) -> GraphBatch:
    """Packed bytes (a tensor or a ``Staged``) of template ``tmpl`` ->
    ``GraphBatch`` on their device."""
    legacy = (isinstance(tmpl, WireBatch)
              and np.dtype(tmpl.graph_rle.dtype) == np.uint16)
    return decompress(unpack(ready(buf), tmpl), symmetric,
                      legacy_ids=legacy)


def is_packed(batch) -> bool:
    """Whether ``batch`` is a packed batch, ``('packed', buf, template,
    symmetric)``."""
    return type(batch) is tuple and batch[0] == 'packed'


def pack_batch(batch: GraphBatch, device: torch.device) -> tuple:
    """A host ``GraphBatch`` as ``('packed', buf, template, symmetric)``
    with its bytes on ``device``."""
    wire = compress(batch)
    return ('packed', upload_pack(wire, device), template(wire),
            batch.inv_recv_perm is not None)
