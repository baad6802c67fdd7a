"""Device-resident dataset: batches collated on the device from item ids
(counterpart of ``pointvs_tpu/data/device_dataset.py``).

The featurised dataset goes to the device once, as a handful of
concatenated arrays (features, coordinates, item-local edges, per-item
offsets). Each step then sends only the sampled item ids, and
``collate_from_ids`` builds on the device the ``GraphBatch`` that the
host's ``buckets.pad_graphs_to_batch`` would have built, with
searchsorted and gathers and no sort: each item's edges are sorted by
sender and concatenate in slot order with increasing node offsets, so the
batch's edges are sorted by sender, and each item's receiver permutation
shifts by the item's edge offset into the batch's ``recv_perm``. For
``rotate=False`` the batch equals the host's in every field, bit for bit.

- ``build_host_store``: one featurisation pass (with the dataset's
  whole-complex rotation off) into a ``HostStore``, each item's edges
  sorted stably by sender (``SynthPharmDataset``'s come unsorted; the
  host collator sorts its batches the same way); ``DeviceGraphStore``
  puts its arrays on an explicit ``torch.device``. Index arrays keep the
  smallest lossless type (uint16 travels as int16 of the same bits).
- ``random_rotations`` / ``rotate_per_graph``: the whole-complex rotation
  moved to the device, one uniform rotation a graph slot keyed by (the
  step's key, the item id) as the reference keys it
  (``pointvs_tpu/parallel/steps.py``): ``fold_in(step rng, 0x526f7461)``,
  then ``fold_in(., id)``, then ``normal(., (4,))``. The quaternions are
  drawn on the host (``ops/prng.py``) and turned into matrices on the
  device; ``x @ M`` in full float32.
- Hybrid tail: augmented actives re-rotate the raw ligand before boxing,
  so their graphs change every epoch. The store gives each a slot of the
  dataset's deterministic capacity (``aug_size_cap``) at its end, and at
  each training epoch's start ``DeviceGraphStore.refresh`` featurises
  the epoch's rotations (keyed by seed, epoch and item, as the streaming
  path draws them) and copies the tail in place; ``prefetch_refresh``
  featurises the next epoch's in a background thread.
- The chunked library (``plan_chunks``, ``pack_chunk``,
  ``expand_chunk``): a library past the memory budget goes to the device
  in ranges of items, each packed on the host into compact buffers of
  one fixed shape and expanded on the device. The raw codec (the
  default) has four encodings: ``degrees`` (senders as per-node
  out-degrees), ``coords16`` (per-axis fixed point; lossy, within half a
  step), ``rperm12`` (12-bit receiver ranks, pairs in 3 bytes) and
  ``deg8`` (uint8 degrees). The other codec (``raw=False``, the screen's
  ``POINTVS_SCREEN_CHUNK_RAW=0``) ships uint16 edge lists and exact
  coordinates: of a mirrored store only the half with sender < receiver,
  rebuilt on the device by two stable sorts; else the full lists, the
  receiver ranks from one stable sort.
- ``save_host_store`` / ``load_host_store``: the built store as one flat
  file (``data/blob.py``) under its own format tag.

The reference's window-capacity measurement (``batch_row_cap``) and its
store-shape buckets for compiled-program reuse have no counterpart: the
CUDA kernels need neither (ROADMAP.md).
"""
from __future__ import annotations

import os
import threading
import time
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pointvs_tpu_torch.data.blob import load_blob, save_blob
from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.native.build import counting_argsort
from pointvs_tpu_torch.ops import prng

LOG = get_logger()
ROTATION_SALT = 0x526f7461   # the reference's fold of the step key
STORE_FORMAT = 'pointvs-torch-store-1'


class DeviceCollateSpec(NamedTuple):
    """Shapes and flags of one batch collated on the device."""
    n_pad: int
    e_pad: int
    num_graphs: int       # graph slots
    symmetric: bool       # inv_recv_perm exists (HostStore.symmetric)
    rotate: bool          # a random rotation per graph (training + rot)


class DeviceStoreArrays(NamedTuple):
    """The store's arrays (numpy on the host, tensors on the device). Edge
    ids are item-local. ``node_start`` / ``edge_start`` delimit each
    item's slot (its capacity, which equals its size unless it is an
    augmented item); ``node_len`` / ``edge_len`` are the actual sizes."""
    feats: np.ndarray       # [N_tot, F] uint8 (0/1 bits) or float32
    coords: np.ndarray      # [N_tot, 3] float32
    senders: np.ndarray     # [E_tot] uint16/int32, item-local node ids
    receivers: np.ndarray   # [E_tot] uint16/int32
    rperm: np.ndarray       # [E_tot] uint16/int32, item-local edge ranks
    eclass: np.ndarray      # [E_tot] uint8 edge class (0-2)
    node_start: np.ndarray  # [n_items+1] int32 (slot offsets)
    edge_start: np.ndarray  # [n_items+1] int32 (slot offsets)
    node_len: np.ndarray    # [n_items] int32 (actual, <= slot size)
    edge_len: np.ndarray    # [n_items] int32
    y: np.ndarray           # [n_items] or [n_items, 3] float32
    strain: np.ndarray      # [n_items, 2] float32


class HostStore(NamedTuple):
    """The host arrays and what the loader reads about each item."""
    arrays: DeviceStoreArrays
    num_nodes: np.ndarray         # [n_items] int64
    num_edges: np.ndarray         # [n_items] int64
    lig_fnames: List[str]
    rec_fnames: List[str]
    symmetric: bool               # each item's receivers, sorted, equal its
    #                               senders: the host collator's test for
    #                               a batch's inv_recv_perm
    rot: bool                     # the dataset wanted per-epoch rotation
    nbytes: int                   # upload size
    aug_from: int                 # first augmented item (n_items: none)
    aug_epoch: List[int]          # [epoch the tail holds] (mutable box)


def hybrid_enabled() -> bool:
    return os.environ.get('POINTVS_DD_HYBRID', '1') != '0'


def store_eligibility(dataset) -> Optional[str]:
    """None when ``dataset`` can live on the device, else the reason."""
    if getattr(dataset, 'p_remove_entity', 0) > 0:
        return 'p_remove_entity resamples graphs every epoch'
    if getattr(dataset, 'p_noise', -1) > 0:
        return 'p_noise flips labels every epoch'
    if getattr(dataset, 'pre_aug_ds_len', len(dataset)) != len(dataset):
        if not hybrid_enabled():
            return ('augmented actives re-rotate the raw ligand before '
                    'boxing and POINTVS_DD_HYBRID=0 disables the hybrid '
                    'refresh path')
        if not hasattr(dataset, 'set_epoch'):
            return ('augmented actives need the dataset to support '
                    'deterministic per-epoch rotations (set_epoch)')
    return None


def _idx_dtype(max_value: int):
    return np.uint16 if max_value < 65536 else np.int32


def _item_rperm(receivers: np.ndarray) -> np.ndarray:
    """The stable argsort of one item's receivers."""
    if not len(receivers):
        return np.zeros(0, np.int32)
    return counting_argsort(receivers, int(receivers.max()))


def _write_item(arrays: DeviceStoreArrays, i: int, s,
                check_symmetric: bool) -> bool:
    """Write sample ``s`` into item ``i``'s slot; returns whether its
    edges are symmetric (``HostStore.symmetric``; True when not
    checked)."""
    n_lo, e_lo = int(arrays.node_start[i]), int(arrays.edge_start[i])
    n_i, e_i = s.num_nodes, s.num_edges
    if (n_lo + n_i > int(arrays.node_start[i + 1])
            or e_lo + e_i > int(arrays.edge_start[i + 1])):
        raise RuntimeError(
            f'augmented item {i} outgrew its store slot ({n_i} nodes / '
            f'{e_i} edges vs capacity {int(arrays.node_start[i + 1]) - n_lo}'
            f' / {int(arrays.edge_start[i + 1]) - e_lo}); the store was '
            f'built under other augmentation settings - rebuild it or set '
            f'POINTVS_DD_HYBRID=0')
    f = np.asarray(s.node_feats, np.float32)
    if arrays.feats.dtype == np.uint8 and not np.all((f == 0) | (f == 1)):
        raise RuntimeError('non-binary features in a uint8 store')
    arrays.feats[n_lo:n_lo + n_i] = f
    arrays.coords[n_lo:n_lo + n_i] = np.asarray(s.coords, np.float32)
    arrays.node_len[i] = n_i
    arrays.edge_len[i] = e_i
    if not e_i:
        return True
    sl, rl = np.asarray(s.senders), np.asarray(s.receivers)
    eclass = np.argmax(s.edge_attr, axis=-1)
    if not np.all(sl[1:] >= sl[:-1]):
        # Sorted stably by sender, as the host collator sorts a batch.
        order = counting_argsort(sl, int(sl.max()))
        sl, rl, eclass = sl[order], rl[order], eclass[order]
    rp = _item_rperm(rl)
    arrays.senders[e_lo:e_lo + e_i] = sl
    arrays.receivers[e_lo:e_lo + e_i] = rl
    arrays.rperm[e_lo:e_lo + e_i] = rp
    arrays.eclass[e_lo:e_lo + e_i] = eclass
    return not check_symmetric or np.array_equal(rl[rp], sl)


def _norot_getitem(dataset, i):
    """``dataset[i]`` with the whole-complex rotation off."""
    had_rot = bool(getattr(dataset, 'rot', False))
    if had_rot:
        dataset.rot = False
    try:
        return dataset[i]
    finally:
        if had_rot:
            dataset.rot = True


def build_host_store(dataset) -> HostStore:
    """One featurisation pass over ``dataset`` into the store's arrays,
    with the whole-complex rotation off (it is applied on the device each
    step, where the dataset's own ``__getitem__`` would apply it).
    Augmented actives get slots of the dataset's ``aug_size_cap``, filled
    for each epoch by ``refresh_augmented``."""
    from pointvs_tpu_torch.data.dataset import PointCloudDataset
    reason = store_eligibility(dataset)
    if reason is not None:
        raise ValueError(f'dataset cannot live on the device: {reason}')
    # Only a dataset whose own __getitem__ applies ``rot`` gets it on the
    # device: a subclass that ignores it must not gain a rotation.
    rot = (bool(getattr(dataset, 'rot', False))
           and type(dataset).__getitem__ is PointCloudDataset.__getitem__)
    n_items = len(dataset)
    if not n_items:
        raise ValueError('empty dataset')
    aug_from = getattr(dataset, 'pre_aug_ds_len', n_items)
    aug_epoch = int(getattr(dataset, '_aug_epoch', 0))

    t0 = time.perf_counter()
    samples = [_norot_getitem(dataset, i) for i in range(n_items)]
    num_nodes = np.array([s.num_nodes for s in samples], np.int64)
    num_edges = np.array([s.num_edges for s in samples], np.int64)
    node_slot, edge_slot = num_nodes.copy(), num_edges.copy()
    for i in range(aug_from, n_items):
        n_cap, e_cap = dataset.aug_size_cap(i)
        node_slot[i] = max(node_slot[i], n_cap)
        edge_slot[i] = max(edge_slot[i], e_cap)
    node_start = np.zeros(n_items + 1, np.int32)
    edge_start = np.zeros(n_items + 1, np.int32)
    np.cumsum(node_slot, out=node_start[1:])
    np.cumsum(edge_slot, out=edge_start[1:])
    n_tot, e_tot = int(node_start[-1]), int(edge_start[-1])

    binary = all(np.all((np.asarray(s.node_feats) == 0)
                        | (np.asarray(s.node_feats) == 1)) for s in samples)
    # 0/1 features (the bit-vector featurisation) travel as uint8.
    feats = np.zeros((n_tot, samples[0].node_feats.shape[1]),
                     np.uint8 if binary else np.float32)
    idx_t = _idx_dtype(int(node_slot.max(initial=1)))
    y0 = np.asarray(samples[0].y, np.float32)
    y = (np.stack([np.asarray(s.y, np.float32) for s in samples])
         if y0.ndim else np.array([s.y for s in samples], np.float32))
    arrays = DeviceStoreArrays(
        feats=feats, coords=np.zeros((n_tot, 3), np.float32),
        senders=np.zeros(e_tot, idx_t), receivers=np.zeros(e_tot, idx_t),
        rperm=np.zeros(e_tot, _idx_dtype(int(edge_slot.max(initial=1)))),
        eclass=np.full(e_tot, 3, np.uint8), node_start=node_start,
        edge_start=edge_start, node_len=np.zeros(n_items, np.int32),
        edge_len=np.zeros(n_items, np.int32), y=y,
        strain=np.array([(s.dE or 0.0, s.rmsd or 0.0) for s in samples],
                        np.float32))
    if aug_from >= n_items:
        symmetric = _write_dense(arrays, samples, num_nodes, num_edges)
    else:
        symmetric = True
        for i, s in enumerate(samples):
            symmetric &= _write_item(arrays, i, s, check_symmetric=symmetric)
    nbytes = sum(a.nbytes for a in arrays)
    LOG.info(f'Device-dataset store: {n_items} items '
             f'({max(0, n_items - aug_from)} augmented), {n_tot} nodes, '
             f'{e_tot} edges, {nbytes / 1e6:.1f} MB, symmetric={symmetric},'
             f' built in {time.perf_counter() - t0:.1f}s')
    return HostStore(
        arrays=arrays, num_nodes=num_nodes, num_edges=num_edges,
        lig_fnames=[s.lig_fname for s in samples],
        rec_fnames=[s.rec_fname for s in samples], symmetric=symmetric,
        rot=rot, nbytes=nbytes, aug_from=min(aug_from, n_items),
        aug_epoch=[aug_epoch])


def _write_dense(arrays: DeviceStoreArrays, samples, num_nodes,
                 num_edges) -> bool:
    """Fill a store without an augmented tail in one vectorised pass;
    returns whether every item is symmetric."""
    arrays.feats[:] = np.concatenate([np.asarray(s.node_feats)
                                      for s in samples])
    arrays.coords[:] = np.concatenate([np.asarray(s.coords)
                                       for s in samples])
    arrays.node_len[:] = num_nodes
    arrays.edge_len[:] = num_edges
    e_tot = len(arrays.senders)
    if not e_tot:
        return True
    s_all = np.concatenate([np.asarray(s.senders) for s in samples])
    r_all = np.concatenate([np.asarray(s.receivers) for s in samples])
    eclass = np.concatenate(
        [np.argmax(s.edge_attr, axis=-1) for s in samples if s.num_edges])
    e_off = np.repeat(arrays.edge_start[:-1].astype(np.int64), num_edges)
    n_off = np.repeat(arrays.node_start[:-1].astype(np.int64), num_edges)
    # Stable sorts of the store-global node ids (items' node ranges
    # ascend, so each keeps the items apart): every item's edges by
    # sender, as the host collator sorts a batch (a no-op for the
    # datasets whose edges come sorted), then each item's receiver order.
    n_tot = int(arrays.node_start[-1])
    by_sender = counting_argsort(s_all + n_off, n_tot)
    s_all, r_all = s_all[by_sender], r_all[by_sender]
    rp_g = counting_argsort(r_all + n_off, n_tot)
    arrays.senders[:] = s_all
    arrays.receivers[:] = r_all
    arrays.rperm[:] = rp_g - e_off
    arrays.eclass[:] = eclass[by_sender]
    return bool(np.array_equal(r_all[rp_g], s_all))


def refresh_augmented(host: HostStore, dataset, epoch: int,
                      samples=None) -> Optional[dict]:
    """Featurise the augmented tail for ``epoch`` into the host arrays and
    return the tail's slices, or None when there is nothing to do.
    ``samples`` (from a background prefetch) skips the featurisation."""
    n_items = len(host.num_nodes)
    if host.aug_from >= n_items or host.aug_epoch[0] == int(epoch):
        return None
    if len(dataset) != n_items:
        raise ValueError('store was built from a different dataset')
    t0 = time.perf_counter()
    dataset.set_epoch(int(epoch))
    arrays = host.arrays
    for i in range(host.aug_from, n_items):
        s = (samples[i - host.aug_from] if samples is not None
             else _norot_getitem(dataset, i))
        if not _write_item(arrays, i, s, check_symmetric=host.symmetric):
            # The collation takes the symmetric fast path for this store.
            raise RuntimeError(f'augmented item {i} lost edge symmetry at '
                               f'epoch {epoch}; set POINTVS_DD_HYBRID=0')
        host.num_nodes[i] = s.num_nodes
        host.num_edges[i] = s.num_edges
    host.aug_epoch[0] = int(epoch)
    n_lo = int(arrays.node_start[host.aug_from])
    e_lo = int(arrays.edge_start[host.aug_from])
    a_lo = host.aug_from
    LOG.info(f'Hybrid store refresh: {n_items - a_lo} augmented items '
             f'featurised for epoch {epoch} in '
             f'{time.perf_counter() - t0:.2f}s')
    return {'feats': (n_lo, arrays.feats[n_lo:]),
            'coords': (n_lo, arrays.coords[n_lo:]),
            'senders': (e_lo, arrays.senders[e_lo:]),
            'receivers': (e_lo, arrays.receivers[e_lo:]),
            'rperm': (e_lo, arrays.rperm[e_lo:]),
            'eclass': (e_lo, arrays.eclass[e_lo:]),
            'node_len': (a_lo, arrays.node_len[a_lo:]),
            'edge_len': (a_lo, arrays.edge_len[a_lo:])}


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``device``; uint16 as int16 of the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a).to(device, copy=True)


def _as_index(t: torch.Tensor) -> torch.Tensor:
    """An index array of the store as int64 (int16 holds uint16 bits)."""
    if t.dtype == torch.int16:
        return t.to(torch.int64) & 0xFFFF
    return t.to(torch.int64)


class DeviceGraphStore:
    """A host store and its arrays on ``device``."""

    def __init__(self, host: HostStore, device: torch.device):
        self.host = host
        self.device = torch.device(device)
        self.arrays = DeviceStoreArrays(*[_to_tensor(a, self.device)
                                          for a in host.arrays])
        self._prefetch = None   # (epoch, thread, result box)

    def prefetch_refresh(self, dataset, epoch: int) -> None:
        """Featurise epoch ``epoch``'s augmented graphs in a background
        thread (their rotations are known in advance), for ``refresh``."""
        n_items = len(self.host.num_nodes)
        if (self.host.aug_from >= n_items
                or self.host.aug_epoch[0] == int(epoch)
                or not hasattr(dataset, 'aug_item')
                or self._prefetch is not None):
            return
        box = {}

        def work():
            try:
                box['samples'] = [dataset.aug_item(i, int(epoch))
                                  for i in range(self.host.aug_from,
                                                 n_items)]
            except Exception as exc:   # refresh featurises synchronously
                box['error'] = exc

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        self._prefetch = (int(epoch), thread, box)

    def refresh(self, dataset, epoch: int) -> None:
        """Featurise the augmented tail for ``epoch`` (or take the
        prefetched graphs) and copy it into the device arrays in place;
        the slots never move."""
        samples = None
        if self._prefetch is not None:
            pf_epoch, thread, box = self._prefetch
            self._prefetch = None
            thread.join()
            if pf_epoch == int(epoch):
                samples = box.get('samples')
        tail = refresh_augmented(self.host, dataset, epoch, samples=samples)
        if tail is None:
            return
        for name, (lo, values) in tail.items():
            dst = getattr(self.arrays, name)
            dst[lo:lo + len(values)].copy_(_to_tensor(values, self.device),
                                           non_blocking=False)

    def __repr__(self):
        return (f'DeviceGraphStore({len(self.host.num_nodes)} items, '
                f'{self.host.nbytes / 1e6:.1f} MB on {self.device})')


# --------------------------------------------------------------------- #
# Collation on the device


def _ids_tensor(ids, device: torch.device) -> torch.Tensor:
    """Item ids (numpy or a tensor; -1 marks an empty slot) as int64 on
    ``device``, through pinned memory to a GPU."""
    if torch.is_tensor(ids):
        return ids.to(device, torch.int64)
    t = torch.from_numpy(np.ascontiguousarray(ids, np.int64))
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t


def collate_from_ids(store: DeviceStoreArrays, ids,
                     spec: DeviceCollateSpec) -> GraphBatch:
    """ids [B] (-1 = empty slot) -> the ``GraphBatch`` that
    ``buckets.pad_graphs_to_batch`` builds from those items, on the
    store's device."""
    device = store.node_start.device
    b, n_pad, e_pad = spec.num_graphs, spec.n_pad, spec.e_pad
    ids = _ids_tensor(ids, device).reshape(-1)
    valid = ids >= 0
    idc = torch.where(valid, ids, 0)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    # Actual sizes, not slot sizes: augmented slots have spare capacity.
    nlen = torch.where(valid, store.node_len[idc].to(torch.int64), zero)
    elen = torch.where(valid, store.edge_len[idc].to(torch.int64), zero)
    nb, eb = torch.cumsum(nlen, 0), torch.cumsum(elen, 0)
    node_start = store.node_start.to(torch.int64)
    edge_start = store.edge_start.to(torch.int64)

    row = torch.arange(n_pad, dtype=torch.int64, device=device)
    gid = torch.searchsorted(nb, row, right=True)
    gc = gid.clamp_max(b - 1)
    in_n = row < nb[-1]
    nsrc = torch.where(in_n, node_start[idc[gc]] + row - (nb - nlen)[gc],
                       zero)
    in_n2 = in_n[:, None]
    node_feats = torch.where(in_n2, store.feats[nsrc].to(torch.float32),
                             0.0)
    coords = torch.where(in_n2, store.coords[nsrc], 0.0)

    erow = torch.arange(e_pad, dtype=torch.int64, device=device)
    egid = torch.searchsorted(eb, erow, right=True)
    egc = egid.clamp_max(b - 1)
    in_e = erow < eb[-1]
    edst0 = (eb - elen)[egc]
    esrc = torch.where(in_e, edge_start[idc[egc]] + erow - edst0, zero)
    node_off = (nb - nlen)[egc]
    senders = torch.where(in_e, _as_index(store.senders[esrc]) + node_off,
                          n_pad)
    receivers = torch.where(in_e,
                            _as_index(store.receivers[esrc]) + node_off,
                            n_pad)
    eclass = torch.where(in_e, store.eclass[esrc].to(torch.int64), 3)
    edge_attr = (eclass[:, None] == torch.arange(
        3, device=device)).to(torch.float32)
    recv_perm = torch.where(in_e, _as_index(store.rperm[esrc]) + edst0,
                            erow).to(torch.int32)
    inv_recv_perm = None
    if spec.symmetric:
        # The inverse permutation, as the host collator forms it (for a
        # lexicographically sorted symmetric edge list, recv_perm itself).
        inv_recv_perm = torch.empty_like(recv_perm).scatter_(
            0, recv_perm.to(torch.int64), erow.to(torch.int32))

    y = store.y[idc]
    y = torch.where(valid if y.ndim == 1 else valid[:, None], y, 0.0)
    strain = torch.where(valid[:, None], store.strain[idc], 0.0)
    return GraphBatch(
        node_feats=node_feats, coords=coords,
        node_mask=in_n.to(torch.float32),
        graph_id=torch.where(in_n, gid, b).to(torch.int32),
        senders=senders.to(torch.int32), receivers=receivers.to(torch.int32),
        edge_attr=edge_attr, edge_mask=in_e.to(torch.float32), y=y,
        graph_mask=valid.to(torch.float32), strain=strain,
        recv_perm=recv_perm, inv_recv_perm=inv_recv_perm)


def rotation_key(seed: int, global_iter: int) -> np.ndarray:
    """The rotation key of one training step of a Trainer seeded ``seed``:
    ``fold_in(step_rng, 0x526f7461)``, as the reference's ids step folds
    its step key."""
    return prng.fold_in(prng.step_rng(seed, global_iter), ROTATION_SALT)


def rotation_quaternions(key, ids) -> np.ndarray:
    """[B, 4] float32: slot i's ``jax.random.normal(fold_in(key, id), (4,))``
    (an empty slot draws item 0's), on the host."""
    ids = np.maximum(np.asarray(ids, np.int64).reshape(-1), 0)
    return prng.normal(prng.fold_in(np.asarray(key, np.uint32), ids), (4,))


def quats_to_mats(q: torch.Tensor) -> torch.Tensor:
    """[B, 4] quaternions -> [B, 3, 3] rotation matrices (det +1), after
    normalising each as the reference does."""
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=1,
                                                     keepdim=True), 1e-12)
    w, x, y, z = q.unbind(1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def random_rotations(key, ids, device=torch.device('cpu')) -> torch.Tensor:
    """One rotation matrix a graph slot, uniform over SO(3) and keyed by
    (``key``, item id): an item keeps its rotation wherever it sits in the
    batch. The quaternions are drawn on the host; the matrices are built
    on ``device``."""
    q = torch.from_numpy(rotation_quaternions(key, ids))
    if torch.device(device).type == 'cuda':
        q = q.pin_memory().to(device, non_blocking=True)
    return quats_to_mats(q)


def rotate_per_graph(batch: GraphBatch, key, ids,
                     num_graphs: int) -> GraphBatch:
    """Each graph's coordinates times its rotation (``x @ M``, as the
    host rotation applies it), in full float32; padding rows stay 0."""
    mats = random_rotations(key, ids, batch.coords.device)
    mg = mats[batch.graph_id.to(torch.int64).clamp_max(num_graphs - 1)]
    # The three products summed elementwise in a fixed order: no TF32
    # matrix unit, and the same bits on the card as on the CPU.
    c = batch.coords
    coords = (c[:, 0:1] * mg[:, 0] + c[:, 1:2] * mg[:, 1]
              + c[:, 2:3] * mg[:, 2])
    coords = torch.where(batch.node_mask[:, None] > 0, coords, 0.0)
    return batch._replace(coords=coords)


# --------------------------------------------------------------------- #
# The chunked library


class StoreChunkSpec(NamedTuple):
    """Fixed shapes and encodings shared by every chunk."""
    items: int          # item slots a chunk
    n_fix: int          # node rows (a multiple of 8, for the bit unpack)
    eh_fix: int         # edge slots (a multiple of 4, for 2-bit classes)
    feat_dim: int
    half: bool          # the store is mirrored (``_mirrored``). Raw
    #                     codec: receivers travel implicitly as
    #                     senders[rperm]; else only the half of each
    #                     item's edges with sender < receiver travels
    raw: bool = True
    degrees: bool = False   # senders as per-node out-degrees
    coords16: bool = False  # coordinates in per-axis fixed point (lossy)
    rperm12: bool = False   # 12-bit receiver ranks, pairs in 3 bytes
    deg8: bool = False      # out-degrees as uint8


def _max_out_degree(host: HostStore) -> int:
    """The largest out-degree of any node: runs of equal senders, broken
    at item boundaries too."""
    s = host.arrays.senders
    if not len(s):
        return 0
    breaks = np.flatnonzero(s[1:] != s[:-1]).astype(np.int64) + 1
    bounds = np.union1d(np.concatenate(([0], breaks, [len(s)])),
                        host.arrays.edge_start.astype(np.int64))
    return int(np.diff(bounds).max(initial=0))


def _mirrored(host: HostStore) -> bool:
    """Whether each item's receiver ranks pair every edge with its mirror:
    senders[rperm] == receivers and receivers[rperm] == senders (true of
    symmetric edge lists sorted by sender and then receiver)."""
    a = host.arrays
    rp = a.rperm.astype(np.int64) + np.repeat(
        a.edge_start[:-1].astype(np.int64), np.diff(a.edge_start))
    return bool(np.array_equal(a.senders[rp], a.receivers)
                and np.array_equal(a.receivers[rp], a.senders))


def plan_chunks(host: HostStore, budget_bytes: float, raw: bool = True):
    """(ranges, spec): contiguous item ranges whose expanded device bytes
    fit ``budget_bytes`` (a single item past it is a range of its own),
    and the chunks' fixed shapes: the raw codec, or (``raw=False``) uint16
    edge lists, half of them where the store is mirrored."""
    if host.aug_from < len(host.num_nodes):
        raise ValueError('chunked stores do not support augmented tails')
    a = host.arrays
    if not raw and int(np.max(host.num_nodes, initial=0)) >= 0xffff:
        raise ValueError('an item has more nodes than uint16 ids can name; '
                         'use the raw chunk codec')
    ns, es = a.node_start, a.edge_start
    feat_dim = a.feats.shape[1]
    degrees = (raw and a.rperm.itemsize <= 2
               and os.environ.get('POINTVS_CHUNK_DEGREES', '1') != '0')
    coords16 = raw and os.environ.get('POINTVS_CHUNK_COORDS16', '1') != '0'
    rperm12 = (raw and int(np.max(a.edge_len, initial=0)) < 4096
               and os.environ.get('POINTVS_CHUNK_RPERM12', '1') != '0')
    deg8 = (degrees and _max_out_degree(host) < 256
            and os.environ.get('POINTVS_CHUNK_DEG8', '1') != '0')
    n_items = len(host.num_nodes)
    # Balanced ranges of the expanded device bytes (uint8 features and
    # float32 coordinates a node; int32 senders, receivers and ranks and
    # a class byte an edge): every chunk has the largest range's shape.
    per_item = (np.diff(ns).astype(np.float64) * (feat_dim + 12)
                + np.diff(es).astype(np.float64) * 13)
    cum = np.concatenate([[0.0], np.cumsum(per_item)])
    k = max(1, int(np.ceil(cum[-1] / budget_bytes)))
    while True:
        if k >= n_items:
            # One item a range: the even split may not separate a heavy
            # item from its neighbours.
            bounds = np.arange(n_items + 1)
            break
        splits = np.searchsorted(cum, cum[-1] * np.arange(1, k) / k)
        splits = (np.unique(np.clip(splits, 1, n_items - 1)) if k > 1
                  else np.zeros(0, np.int64))
        bounds = np.concatenate([[0], splits, [n_items]]).astype(np.int64)
        if not np.any((np.diff(cum[bounds]) > budget_bytes)
                      & (np.diff(bounds) > 1)):
            break
        k += 1
    ranges = [(int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:])
              if hi > lo]
    n_fix = max(int(ns[hi] - ns[lo]) for lo, hi in ranges)
    e_fix = max(int(es[hi] - es[lo]) for lo, hi in ranges)
    half = _mirrored(host)
    if raw:
        eh_fix = -(-e_fix // 4) * 4
    else:   # the half list's classes are 2-bit, four to a byte
        eh_fix = -(-(e_fix // 2) // 4) * 4 if half else e_fix
    return ranges, StoreChunkSpec(
        items=max(hi - lo for lo, hi in ranges),
        n_fix=-(-n_fix // 8) * 8, eh_fix=eh_fix, feat_dim=feat_dim,
        half=half, raw=raw, degrees=degrees, coords16=coords16,
        rperm12=rperm12, deg8=deg8)


def _class_bits(classes: np.ndarray) -> np.ndarray:
    e4 = classes.reshape(-1, 4)
    return (e4[:, 0] | (e4[:, 1] << 2) | (e4[:, 2] << 4)
            | (e4[:, 3] << 6)).astype(np.uint8)


def pack_chunk(host: HostStore, lo: int, hi: int,
               spec: StoreChunkSpec) -> dict:
    """Items [lo, hi) -> a dict of padded, compact numpy buffers."""
    a = host.arrays
    n_lo, n_hi = int(a.node_start[lo]), int(a.node_start[hi])
    e_lo, e_hi = int(a.edge_start[lo]), int(a.edge_start[hi])
    n, e, c = n_hi - n_lo, e_hi - e_lo, hi - lo

    feats = np.zeros((spec.n_fix, spec.feat_dim), np.uint8)
    feats[:n] = a.feats[n_lo:n_hi]
    out = {'feat_bits': np.packbits(feats.T, axis=-1, bitorder='little')}
    if spec.coords16:
        # Per-axis fixed point over the chunk's box: error <= scale / 2.
        real = a.coords[n_lo:n_hi]
        lo3 = real.min(axis=0) if n else np.zeros(3, np.float32)
        hi3 = real.max(axis=0) if n else np.zeros(3, np.float32)
        scale = np.maximum((hi3 - lo3) / 65535.0, 1e-12).astype(np.float32)
        coords_q = np.zeros((spec.n_fix, 3), np.uint16)
        coords_q[:n] = np.clip(np.rint((real - lo3) / scale), 0,
                               65535).astype(np.uint16)
        out.update(coords_q=coords_q, coords_lo=lo3.astype(np.float32),
                   coords_scale=scale)
    else:
        coords = np.zeros((spec.n_fix, 3), np.float32)
        coords[:n] = a.coords[n_lo:n_hi]
        out['coords'] = coords

    def padded(values, length, fill, dtype):
        buf = np.full((length,) + values.shape[1:], fill, dtype)
        buf[:len(values)] = values
        return buf

    node_start = a.node_start[lo:hi + 1] - n_lo
    edge_start = a.edge_start[lo:hi + 1] - e_lo
    out.update(
        node_start=padded(node_start, spec.items + 1, node_start[-1],
                          np.int32),
        edge_start=padded(edge_start, spec.items + 1, edge_start[-1],
                          np.int32),
        node_len=padded(a.node_len[lo:hi], spec.items, 0, np.int32),
        edge_len=padded(a.edge_len[lo:hi], spec.items, 0, np.int32),
        y=padded(a.y[lo:hi], spec.items, 0, np.float32),
        strain=padded(a.strain[lo:hi], spec.items, 0, np.float32),
        n_real=np.int32(n), e_real=np.int32(e))
    senders, receivers = a.senders[e_lo:e_hi], a.receivers[e_lo:e_hi]
    eclass = a.eclass[e_lo:e_hi]
    if not spec.raw and spec.half:
        keep = senders < receivers      # each item's order is kept
        out.update(
            half_senders=padded(senders[keep], spec.eh_fix, 0xffff,
                                np.uint16),
            half_receivers=padded(receivers[keep], spec.eh_fix, 0xffff,
                                  np.uint16),
            half_class_bits=_class_bits(padded(eclass[keep], spec.eh_fix,
                                               3, np.uint8)))
        return out
    if not spec.raw:
        out.update(full_senders=padded(senders, spec.eh_fix, 0, np.uint16),
                   full_receivers=padded(receivers, spec.eh_fix, 0,
                                         np.uint16),
                   full_class=padded(eclass, spec.eh_fix, 3, np.uint8))
        return out
    out['raw_class_bits'] = _class_bits(padded(eclass, spec.eh_fix, 3,
                                               np.uint8))
    rperm = padded(a.rperm[e_lo:e_hi], spec.eh_fix, 0, a.rperm.dtype)
    if spec.rperm12:
        # Item-local ranks < 4096: value pairs in 3 bytes (eh_fix % 4 == 0).
        v = rperm.astype(np.uint16)
        v0, v1 = v[0::2], v[1::2]
        rp12 = np.empty((spec.eh_fix // 2, 3), np.uint8)
        rp12[:, 0] = v0 & 0xff
        rp12[:, 1] = ((v0 >> 8) & 0xf) | ((v1 & 0xf) << 4)
        rp12[:, 2] = (v1 >> 4) & 0xff
        out['raw_rperm12'] = rp12
    else:
        out['raw_rperm'] = rperm
    if spec.degrees:
        # Each item's edges are sorted by sender, so the sender list is the
        # run-length expansion of the chunk's per-node out-degrees.
        item_ids = np.repeat(np.arange(c), np.diff(a.edge_start[lo:hi + 1]))
        g_send = (a.senders[e_lo:e_hi].astype(np.int64)
                  + (a.node_start[lo:hi].astype(np.int64) - n_lo)[item_ids])
        deg = np.bincount(g_send, minlength=spec.n_fix)
        if deg.max(initial=0) >= 65536:
            raise ValueError('node out-degree exceeds uint16; set '
                             'POINTVS_CHUNK_DEGREES=0')
        out['raw_degrees'] = deg.astype(np.uint8 if spec.deg8
                                        else np.uint16)
    else:
        out['raw_senders'] = padded(senders, spec.eh_fix, 0,
                                    a.senders.dtype)
    if not spec.half:
        out['raw_receivers'] = padded(receivers, spec.eh_fix, 0,
                                      a.receivers.dtype)
    return out


def upload_chunk(packed: dict, device: torch.device) -> dict:
    """A packed chunk's buffers on ``device``."""
    return {k: _to_tensor(np.asarray(v), device) for k, v in packed.items()}


def _classes(bits: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """2-bit edge classes, four to a byte, at positions ``pos``."""
    return ((bits[pos // 4].to(torch.int64) >> (2 * (pos % 4))) & 3).to(
        torch.uint8)


def _item_of(edge_start: torch.Tensor, pos: torch.Tensor,
             items: int) -> torch.Tensor:
    """The item slot that holds each chunk edge position."""
    return (torch.searchsorted(edge_start, pos, right=True) - 1).clamp(
        0, items - 1)


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    """Ties keep their order, on either device: the expanded lists equal
    the host store's bit for bit only so."""
    return torch.sort(x, stable=True).indices


def _expand_raw(packed: dict, spec: StoreChunkSpec):
    """Raw codec: the senders from a cumsum of the degrees and a
    searchsorted, the 12-bit ranks unpacked; receivers, for a mirrored
    store, as senders[rperm]."""
    node_start = packed['node_start'].to(torch.int64)
    edge_start = packed['edge_start'].to(torch.int64)
    n_fix, eh = spec.n_fix, spec.eh_fix
    pos = torch.arange(eh, dtype=torch.int64, device=node_start.device)
    eclass = _classes(packed['raw_class_bits'], pos)
    item_e = _item_of(edge_start, pos, spec.items)
    if spec.degrees:
        deg = _as_index(packed['raw_degrees'])
        offs = torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)])
        g_send = (torch.searchsorted(offs, pos, right=True)
                  - 1).clamp(0, n_fix - 1)
        senders = torch.where(pos < packed['e_real'].to(torch.int64),
                              g_send - node_start[item_e], 0)
    else:
        senders = _as_index(packed['raw_senders'])
    if spec.rperm12:
        b = packed['raw_rperm12'].to(torch.int64)    # [eh / 2, 3]
        v0 = b[:, 0] | ((b[:, 1] & 0xf) << 8)
        v1 = (b[:, 1] >> 4) | (b[:, 2] << 4)
        rperm = torch.stack([v0, v1], dim=1).reshape(-1)
    else:
        rperm = _as_index(packed['raw_rperm'])
    if 'raw_receivers' in packed:
        receivers = _as_index(packed['raw_receivers'])
    else:
        receivers = senders[(rperm + edge_start[item_e]).clamp(0, eh - 1)]
    return senders, receivers, rperm, eclass


def _expand_half(packed: dict, spec: StoreChunkSpec):
    """Half lists: rebased to chunk-global ids (padding at the sentinel
    ``n_fix``), the mirrors first and one stable sort by global sender
    give every item's lists in (sender, receiver) order; the receiver
    ranks come from a stable sort of the global receivers (padding
    last), rebased per item."""
    node_start = packed['node_start'].to(torch.int64)
    edge_start = packed['edge_start'].to(torch.int64)
    n_fix, eh = spec.n_fix, spec.eh_fix
    pos = torch.arange(eh, dtype=torch.int64, device=node_start.device)
    # Each item holds as many half edges as half its edges.
    off = node_start[_item_of(edge_start, 2 * pos, spec.items)]
    real_h = 2 * pos < packed['e_real'].to(torch.int64)
    hs = torch.where(real_h, _as_index(packed['half_senders']) + off, n_fix)
    hr = torch.where(real_h, _as_index(packed['half_receivers']) + off,
                     n_fix)
    hc = _classes(packed['half_class_bits'], pos)
    all_s, all_r = torch.cat([hr, hs]), torch.cat([hs, hr])
    order = _stable_argsort(all_s)
    senders_g, receivers_g = all_s[order], all_r[order]
    epos = torch.arange(2 * eh, dtype=torch.int64, device=pos.device)
    item_e = _item_of(edge_start, epos, spec.items)
    real_e = senders_g < n_fix
    senders = torch.where(real_e, senders_g - node_start[item_e], 0)
    receivers = torch.where(real_e, receivers_g - node_start[item_e], 0)
    eclass = torch.where(real_e, torch.cat([hc, hc])[order], 3)
    rank = _stable_argsort(torch.where(real_e, receivers_g, 2 * n_fix))
    rperm = torch.where(real_e, rank - edge_start[item_e], 0)
    return senders, receivers, rperm, eclass


def _expand_full(packed: dict, spec: StoreChunkSpec):
    """Full lists: the receiver ranks from one stable sort of the global
    receivers (padding last), rebased per item."""
    node_start = packed['node_start'].to(torch.int64)
    edge_start = packed['edge_start'].to(torch.int64)
    pos = torch.arange(spec.eh_fix, dtype=torch.int64,
                       device=node_start.device)
    item_e = _item_of(edge_start, pos, spec.items)
    real_e = pos < packed['e_real'].to(torch.int64)
    senders = torch.where(real_e, _as_index(packed['full_senders']), 0)
    receivers = torch.where(real_e, _as_index(packed['full_receivers']), 0)
    eclass = torch.where(real_e, packed['full_class'], 3)
    rank = _stable_argsort(torch.where(
        real_e, receivers + node_start[item_e], 2 * spec.n_fix))
    rperm = torch.where(real_e, rank - edge_start[item_e], 0)
    return senders, receivers, rperm, eclass


def expand_chunk(packed: dict, spec: StoreChunkSpec) -> DeviceStoreArrays:
    """A packed chunk's tensors -> the store arrays of its items, on the
    chunk's device: the bits unpacked, the fixed-point coordinates mapped
    back, the edge lists by the chunk's codec."""
    node_start = packed['node_start']
    shifts = torch.arange(8, dtype=torch.uint8, device=node_start.device)
    bits = packed['feat_bits']                      # [F, n_fix / 8]
    feats = ((bits[:, :, None] >> shifts) & 1).reshape(
        spec.feat_dim, spec.n_fix).t().contiguous()  # [n_fix, F] uint8
    if spec.coords16:
        coords = (packed['coords_lo'] + _as_index(packed['coords_q']).to(
            torch.float32) * packed['coords_scale'])
    else:
        coords = packed['coords']
    expand = (_expand_raw if spec.raw
              else _expand_half if spec.half else _expand_full)
    senders, receivers, rperm, eclass = expand(packed, spec)
    return DeviceStoreArrays(
        feats=feats, coords=coords, senders=senders.to(torch.int32),
        receivers=receivers.to(torch.int32), rperm=rperm.to(torch.int32),
        eclass=eclass, node_start=node_start,
        edge_start=packed['edge_start'], node_len=packed['node_len'],
        edge_len=packed['edge_len'], y=packed['y'], strain=packed['strain'])


# --------------------------------------------------------------------- #
# The store's disk cache: a re-screen of a library loads the built store
# at disk speed instead of featurising every item again.


def save_host_store(host: HostStore, path) -> None:
    path = Path(path)
    arrays = {f'a_{k}': v for k, v in host.arrays._asdict().items()}
    arrays.update(
        format=np.frombuffer(STORE_FORMAT.encode(), np.uint8).copy(),
        num_nodes=host.num_nodes, num_edges=host.num_edges,
        lig_fnames=np.frombuffer('\n'.join(host.lig_fnames).encode(),
                                 np.uint8).copy(),
        rec_fnames=np.frombuffer('\n'.join(host.rec_fnames).encode(),
                                 np.uint8).copy(),
        flags=np.array([int(host.symmetric), int(host.rot), host.aug_from],
                       np.int64))
    tmp = path.with_name(f'{path.name}.{os.getpid()}.tmp')
    save_blob(tmp, arrays)
    os.replace(tmp, path)


def load_host_store(path) -> Optional[HostStore]:
    """The store saved at ``path``; None when there is none or it was
    written in another format (the JAX package's among them)."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        b = load_blob(path)
    except ValueError:
        return None
    if b.get('format', np.zeros(0, np.uint8)).tobytes() != \
            STORE_FORMAT.encode():
        return None
    arrays = DeviceStoreArrays(**{k[2:]: np.array(v) for k, v in b.items()
                                  if k.startswith('a_')})
    flags = b['flags']
    return HostStore(
        arrays=arrays, num_nodes=np.array(b['num_nodes']),
        num_edges=np.array(b['num_edges']),
        lig_fnames=b['lig_fnames'].tobytes().decode().split('\n'),
        rec_fnames=b['rec_fnames'].tobytes().decode().split('\n'),
        symmetric=bool(flags[0]), rot=bool(flags[1]),
        nbytes=sum(a.nbytes for a in arrays), aug_from=int(flags[2]),
        aug_epoch=[0])
