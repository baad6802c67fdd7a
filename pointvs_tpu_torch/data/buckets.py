"""Padded graph batches (counterpart of ``pointvs_tpu/data/buckets.py``).

Conventions (relied on by the ops and the model):

- node arrays are padded to ``n_pad`` rows; padding rows have
  ``node_mask == 0`` and ``graph_id == num_graphs``;
- edge arrays are padded to ``e_pad`` rows; padding edges have
  ``edge_mask == 0`` and ``senders == receivers == n_pad``;
- ``senders`` are sorted ascending (padding last), as the segment kernels
  require; ``recv_perm`` sorts ``receivers``;
- ``inv_recv_perm`` (the inverse of ``recv_perm``) is present only when the
  edge list is verified symmetric (``receivers[recv_perm] == senders``);
- graph slots beyond the samples have ``graph_mask == 0``;
- ``strain`` holds each slot's (dE, strain RMSD), zeros where a sample
  has none and in empty slots.

``SiamesePair`` (a receptor-only and a ligand-only ``GraphBatch`` of the
same complexes, slot-aligned; labels on the receptor side) and
``DenseBatch`` (zero-padded per-graph point clouds) are the two other
model inputs; ``to_device`` moves any of the three.

Sizes are rounded up to a geometric grid of buckets. The reference also
grows the edge padding until a TPU window-load capacity is met; the CUDA
kernels have no such capacity, so that growth is not ported.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from pointvs_tpu_torch.native.build import counting_argsort


class GraphBatch(NamedTuple):
    """A padded batch of graphs: numpy arrays on the host, tensors on a
    device (see ``to_device``). N padded nodes, E padded edges, B slots."""
    node_feats: np.ndarray   # [N, F] float32
    coords: np.ndarray       # [N, 3] float32
    node_mask: np.ndarray    # [N]    float32
    graph_id: np.ndarray     # [N]    int32 (padding rows = B)
    senders: np.ndarray      # [E]    int32 (sorted; padding = N)
    receivers: np.ndarray    # [E]    int32 (padding = N)
    edge_attr: np.ndarray    # [E, 3] float32
    edge_mask: np.ndarray    # [E]    float32
    y: np.ndarray            # [B] or [B, 3] float32
    graph_mask: np.ndarray   # [B]    float32
    strain: np.ndarray       # [B, 2] float32 (dE, strain RMSD)
    recv_perm: np.ndarray    # [E]    int32
    inv_recv_perm: Optional[np.ndarray] = None   # [E] int32, symmetric only


class SiamesePair(NamedTuple):
    """The two towers' batches of the same complexes, slot by slot: the
    receptor's atoms (``rec``) and the ligand's (``lig``). Labels and the
    graph mask are the receptor side's."""
    rec: GraphBatch
    lig: GraphBatch

    @property
    def y(self):
        return self.rec.y

    @property
    def graph_mask(self):
        return self.rec.graph_mask

    @property
    def num_graphs(self) -> int:
        return self.rec.graph_mask.shape[0]


class DenseBatch(NamedTuple):
    """Zero-padded point clouds, one row per graph slot."""
    p: np.ndarray            # [B, N, 3] float32 coordinates
    v: np.ndarray            # [B, N, F] float32 features
    m: np.ndarray            # [B, N]    float32 (1 = real atom)
    y: np.ndarray            # [B]       float32
    graph_mask: np.ndarray   # [B]       float32

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]


@dataclass
class GraphSample:
    """One preprocessed complex (host side, before batching)."""
    node_feats: np.ndarray    # [n, F] float32
    coords: np.ndarray        # [n, 3] float32
    senders: np.ndarray       # [e] int32
    receivers: np.ndarray     # [e] int32
    edge_attr: np.ndarray     # [e, 3] float32
    y: np.ndarray             # scalar or [3]
    lig_fname: str = ''
    rec_fname: str = ''
    dE: float = 0.0
    rmsd: float = 0.0

    @property
    def num_nodes(self) -> int:
        return self.node_feats.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]


def bucket_sizes(minimum: int, maximum: int, ratio: float = 1.4,
                 multiple: int = 128) -> Sequence[int]:
    """Geometric grid of padded sizes, each a multiple of ``multiple``."""
    sizes = []
    value = float(max(minimum, multiple))
    while True:
        padded = int(-(-value // multiple) * multiple)
        if not sizes or padded > sizes[-1]:
            sizes.append(padded)
        if padded >= maximum:
            return sizes
        value *= ratio


DEFAULT_NODE_BUCKETS = bucket_sizes(128, 65536)
DEFAULT_EDGE_BUCKETS = bucket_sizes(512, 1048576)


def pick_bucket(size: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= size (beyond the grid: the last stride repeats)."""
    idx = bisect.bisect_left(buckets, size)
    if idx < len(buckets):
        return buckets[idx]
    stride = max(buckets[-1] - (buckets[-2] if len(buckets) > 1 else 0), 128)
    return buckets[-1] + int(-(-(size - buckets[-1]) // stride) * stride)


def pad_graphs_to_batch(samples: Sequence[GraphSample],
                        num_graphs: Optional[int] = None,
                        n_pad: Optional[int] = None,
                        e_pad: Optional[int] = None,
                        node_buckets: Sequence[int] = DEFAULT_NODE_BUCKETS,
                        edge_buckets: Sequence[int] = DEFAULT_EDGE_BUCKETS
                        ) -> GraphBatch:
    """Concatenate samples into one padded, sender-sorted GraphBatch; the
    padded sizes are ``n_pad`` / ``e_pad`` or else the smallest bucket
    that fits."""
    if not samples:
        raise ValueError('pad_graphs_to_batch needs at least one sample')
    num_graphs = num_graphs or len(samples)
    if len(samples) > num_graphs:
        raise ValueError(f'{len(samples)} samples for {num_graphs} slots')
    total_nodes = sum(s.num_nodes for s in samples)
    total_edges = sum(s.num_edges for s in samples)
    n_pad = n_pad if n_pad is not None else pick_bucket(
        max(total_nodes, 1), node_buckets)
    e_pad = e_pad if e_pad is not None else pick_bucket(
        max(total_edges, 1), edge_buckets)
    if n_pad < total_nodes or e_pad < total_edges:
        raise ValueError(f'pad sizes ({n_pad},{e_pad}) smaller than actual '
                         f'({total_nodes},{total_edges})')

    feat_dim = samples[0].node_feats.shape[1]
    node_feats = np.zeros((n_pad, feat_dim), np.float32)
    coords = np.zeros((n_pad, 3), np.float32)
    node_mask = np.zeros((n_pad,), np.float32)
    graph_id = np.full((n_pad,), num_graphs, np.int32)
    senders = np.full((e_pad,), n_pad, np.int32)
    receivers = np.full((e_pad,), n_pad, np.int32)
    edge_attr = np.zeros((e_pad, 3), np.float32)
    edge_mask = np.zeros((e_pad,), np.float32)
    y0 = np.asarray(samples[0].y, np.float32)
    y = np.zeros((num_graphs,) + y0.shape, np.float32)
    graph_mask = np.zeros((num_graphs,), np.float32)
    strain = np.zeros((num_graphs, 2), np.float32)

    n_off = e_off = 0
    for gid, s in enumerate(samples):
        n, e = s.num_nodes, s.num_edges
        node_feats[n_off:n_off + n] = s.node_feats
        coords[n_off:n_off + n] = s.coords
        node_mask[n_off:n_off + n] = 1.0
        graph_id[n_off:n_off + n] = gid
        senders[e_off:e_off + e] = s.senders + n_off
        receivers[e_off:e_off + e] = s.receivers + n_off
        if e:
            edge_attr[e_off:e_off + e] = s.edge_attr
        edge_mask[e_off:e_off + e] = 1.0
        y[gid] = np.asarray(s.y, np.float32)
        graph_mask[gid] = 1.0
        strain[gid] = (s.dE or 0.0, s.rmsd or 0.0)
        n_off += n
        e_off += e

    if not np.all(senders[1:] >= senders[:-1]):
        order = counting_argsort(senders, n_pad)
        senders, receivers = senders[order], receivers[order]
        edge_attr, edge_mask = edge_attr[order], edge_mask[order]
    recv_perm = counting_argsort(receivers, n_pad)
    inv_recv_perm = None
    if np.array_equal(receivers[recv_perm], senders):
        inv_recv_perm = np.empty((e_pad,), np.int32)
        inv_recv_perm[recv_perm] = np.arange(e_pad, dtype=np.int32)
    return GraphBatch(node_feats, coords, node_mask, graph_id, senders,
                      receivers, edge_attr, edge_mask, y, graph_mask,
                      strain, recv_perm, inv_recv_perm)


AnyBatch = Union[GraphBatch, SiamesePair, DenseBatch]


def cast_floats(batch: AnyBatch, dtype: torch.dtype) -> AnyBatch:
    """The batch with every floating tensor in ``dtype`` (``--double``
    models take float64 batches; f32 -> f64 is exact)."""
    if isinstance(batch, SiamesePair):
        return SiamesePair(cast_floats(batch.rec, dtype),
                           cast_floats(batch.lig, dtype))
    return type(batch)(*[
        a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a
        for a in batch])


def to_device(batch: AnyBatch, device: torch.device) -> AnyBatch:
    """Host batch -> tensors on ``device`` (a ``SiamesePair`` as its two
    ``GraphBatch``es); to a GPU through pinned memory with non-blocking
    copies."""
    if isinstance(batch, SiamesePair):
        return SiamesePair(to_device(batch.rec, device),
                           to_device(batch.lig, device))

    def move(a):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == 'cuda':
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return type(batch)(*[move(a) for a in batch])
