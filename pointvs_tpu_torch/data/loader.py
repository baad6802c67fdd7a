"""Batched, prefetching graph loader (counterpart of
``pointvs_tpu/data/loader.py``).

Yields ``(batch, BatchMeta)`` with ``batch_size`` graph slots per batch;
a short last batch leaves its spare slots empty (``graph_mask == 0``).
The batch is the model's input layout:

- ``'graph'``: one ``GraphBatch``;
- ``'pair'``: a ``SiamesePair`` of the receptor-only dataset's
  ``GraphBatch`` and the ligand-only ``paired_dataset``'s, each padded to
  its own buckets; both are read at the same indices, the receptor side
  of the whole batch first;
- ``'dense'``: a ``DenseBatch``, every graph padded to the bucket of
  ``DENSE_NODE_BUCKETS`` that holds the batch's largest graph.

- Sampling: in ``mode='train'`` for classification with class weights,
  ``len(dataset)`` draws with replacement by weight; otherwise the items in
  order, shuffled in training. The index stream is the reference's
  ``RandomState(seed)``: ``choice(n, n, replace=True, p=...)`` or
  ``shuffle``.
- Each training pass sets the dataset's epoch (``set_epoch``), which keys
  the augmented actives' rotations.
- With ``prefetch > 0`` one producer thread featurises and collates ahead
  of the consumer; it is the only thread that draws from the dataset's
  random stream, so the draws keep their order. A producer's exception is
  raised in the consumer.
- Deterministic loaders (not training; no rotation, noise or entity
  dropout) keep their collated batches after the first pass.
- After ``enable_device_dataset(store)`` (a
  ``device_dataset.DeviceGraphStore`` of this loader's dataset, the
  graph layout only) the loader yields ``('ids', ids[1, B], store,
  spec)`` batches: the same index stream and buckets, the item ids of
  the batch (-1 for an empty slot) and the ``DeviceCollateSpec`` that
  the step collates them with on the device (``parallel/steps.py``).
  Each training pass first refreshes the store's augmented tail for its
  epoch and starts featurising the next epoch's in the background.

``transfer_fn`` (None by default; the Trainer sets its ``_to_device``,
the screen its packing) is applied to every batch in the producer thread
(``_apply_transfer``), as in the reference: collation, wire packing
(``data/wire.py``) and the host-to-device copy on a side CUDA stream then
overlap the consumer's steps, which wait on the copy's event before they
read it. Without prefetching it runs in the consumer. Cached batches are
kept on the host and transferred again on each pass.
``BatchMeta.y`` and ``graph_mask`` are host copies of the batch's labels
and slot mask ([1, B] for an ids batch, as the reference's loader builds
them); ``BatchMeta.items`` holds the dataset indices of the real slots.
The reference's TPU window capacity (``meta.cap``) is not here.

Scale-out, as the reference's multi-process loader: with ``num_shards``
> 1 the loader is one data-parallel rank's. Every rank draws the same
seeded index stream and keeps its stripe ``idx[shard_index::num_shards]``
(weighted samples included), at ``batch_size`` = the global batch / the
dp ranks, so the union of the ranks' batch k is the one-rank batch k.
Every rank yields ``len(self)`` batches: a stripe that runs out first
yields batches with no real slot. With ``graph_shard`` > 1 (the graph
layout only) each batch is padded as one row and split into
``graph_shard`` edge shards, of which the loader yields shard
``gp_index`` (``parallel/graph_shard.py``); the node and graph arrays are
the row's, on every gp rank alike.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np

from pointvs_tpu_torch.data.buckets import (
    DEFAULT_EDGE_BUCKETS,
    DEFAULT_NODE_BUCKETS,
    AnyBatch,
    GraphBatch,
    SiamesePair,
    bucket_sizes,
    pad_graphs_to_batch,
    pick_bucket,
)
from pointvs_tpu_torch.data.dataset import PointCloudDataset
from pointvs_tpu_torch.models.vanilla import dense_collate

# Nodes per graph (not per batch) for the dense layout, on a finer grid:
# the dense model's work grows with B * N^2.
DENSE_NODE_BUCKETS = bucket_sizes(64, 8192, ratio=1.3, multiple=64)
LAYOUTS = ('graph', 'pair', 'dense')


class BatchMeta:
    """Host metadata for one batch; filenames line up with graph slots."""

    __slots__ = ('lig_fnames', 'rec_fnames', 'y', 'graph_mask', 'items')

    def __init__(self, lig_fnames: List[str], rec_fnames: List[str], y,
                 graph_mask, items=None):
        self.lig_fnames = lig_fnames
        self.rec_fnames = rec_fnames
        self.y = y
        self.graph_mask = graph_mask
        self.items = items


class GraphDataLoader:
    """Iterable over (batch, BatchMeta) pairs."""

    def __init__(self, dataset: PointCloudDataset, batch_size: int = 32,
                 mode: str = 'train', drop_last: bool = False,
                 prefetch: int = 2, seed: int = 0,
                 node_buckets=DEFAULT_NODE_BUCKETS,
                 edge_buckets=DEFAULT_EDGE_BUCKETS, layout: str = 'graph',
                 paired_dataset: PointCloudDataset = None,
                 shard_index: int = 0, num_shards: int = 1,
                 graph_shard: int = 1, gp_index: int = 0):
        if layout not in LAYOUTS:
            raise ValueError(f'unknown layout {layout!r}')
        if (layout == 'pair') != (paired_dataset is not None):
            raise ValueError("layout='pair' takes the ligand-side dataset "
                             'as paired_dataset, and only it does')
        if graph_shard > 1 and layout != 'graph':
            raise ValueError('--graph_shard requires the graph layout')
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.graph_shard = graph_shard
        self.gp_index = gp_index
        self.layout = layout
        self.paired_dataset = paired_dataset
        self.dataset = dataset
        self.batch_size = batch_size
        self.mode = mode
        self.shuffle = mode == 'train'
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        self.node_buckets = node_buckets
        self.edge_buckets = edge_buckets
        self.use_weighted_sampler = (
            mode == 'train' and dataset.model_task == 'classification'
            and dataset.sample_weights is not None)
        self._cacheable = (mode != 'train' and not dataset.rot
                           and dataset.p_noise <= 0
                           and dataset.p_remove_entity <= 0)
        self._batch_cache = None
        # Training passes started; a resumed run's loader counts from 0,
        # as its index stream replays from its seed.
        self._epochs_started = 0
        self.device_store = None
        # Applied to each (host) batch in the producer thread.
        self.transfer_fn = None

    def __len__(self) -> int:
        n = -(-len(self.dataset) // self.num_shards)   # the longest stripe
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.use_weighted_sampler:
            weights = np.asarray(self.dataset.sample_weights, np.float64)
            idx = self.rng.choice(n, size=n, replace=True,
                                  p=weights / weights.sum())
        else:
            idx = np.arange(n)
            if self.shuffle:
                self.rng.shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def _chunks(self, indices):
        """The ``len(self)`` index chunks of an epoch; a stripe that runs
        out yields empty ones."""
        for j in range(len(self)):
            chunk = np.asarray(indices[j * self.batch_size:
                                       (j + 1) * self.batch_size], np.int64)
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield chunk

    def _pad(self, samples):
        return pad_graphs_to_batch(samples, num_graphs=self.batch_size,
                                   node_buckets=self.node_buckets,
                                   edge_buckets=self.edge_buckets)

    def _empty(self, batch):
        """A collated placeholder with no real slot, node or edge (nothing
        of it enters a loss or a whole-batch statistic); its edges are all
        padding, as the wire form's decode reads them."""
        if isinstance(batch, SiamesePair):
            return SiamesePair(self._empty(batch.rec), self._empty(batch.lig))
        blank = dict(y=np.zeros_like(batch.y),
                     graph_mask=np.zeros_like(batch.graph_mask))
        if isinstance(batch, GraphBatch):
            n_pad = batch.node_feats.shape[0]
            order = np.arange(batch.senders.shape[0], dtype=np.int32)
            blank.update(node_mask=np.zeros_like(batch.node_mask),
                         edge_mask=np.zeros_like(batch.edge_mask),
                         graph_id=np.full_like(batch.graph_id,
                                               batch.graph_mask.shape[0]),
                         senders=np.full_like(batch.senders, n_pad),
                         receivers=np.full_like(batch.receivers, n_pad),
                         edge_attr=np.zeros_like(batch.edge_attr),
                         recv_perm=order,
                         inv_recv_perm=(None if batch.inv_recv_perm is None
                                        else order))
        else:   # DenseBatch
            blank.update(m=np.zeros_like(batch.m))
        return batch._replace(**blank)

    def placeholder(self) -> AnyBatch:
        """A batch of this loader's layout and sizes with no real slot,
        node or edge: what a stripe past its end yields."""
        return self._empty(self._collate([0], [self.dataset[0]]))

    def _collate(self, chunk, samples) -> AnyBatch:
        if not len(chunk):   # a stripe past its end
            return self.placeholder()
        if self.layout == 'dense':
            max_len = pick_bucket(max(s.num_nodes for s in samples),
                                  DENSE_NODE_BUCKETS)
            return dense_collate(samples, max_len, self.batch_size)
        if self.layout == 'pair':
            lig = [self.paired_dataset[int(i)] for i in chunk]
            return SiamesePair(self._pad(samples), self._pad(lig))
        if self.graph_shard > 1:
            from pointvs_tpu_torch.parallel.graph_shard import split_edges
            return split_edges(self._pad(samples),
                               self.graph_shard)[self.gp_index]
        return self._pad(samples)

    def enable_device_dataset(self, store) -> None:
        """Collate from ``store`` (built from this loader's dataset) on the
        device from now on."""
        if self.layout != 'graph' or self.graph_shard > 1:
            raise ValueError('device-resident datasets need the graph '
                             'layout without graph sharding')
        if len(store.host.num_nodes) != len(self.dataset):
            raise ValueError('store was built from a different dataset')
        self.device_store = store
        self._batch_cache = None   # cached host batches are the old form

    def _produce_ids(self, indices) -> Iterator[Tuple[tuple, BatchMeta]]:
        """('ids', ids[1, B], store, spec) batches."""
        from pointvs_tpu_torch.data.device_dataset import DeviceCollateSpec
        store = self.device_store
        host = store.host
        rotate = self.mode == 'train' and host.rot
        y_all = host.arrays.y
        for chunk in self._chunks(indices):
            ids = np.full((1, self.batch_size), -1, np.int32)
            ids[0, :len(chunk)] = chunk
            spec = DeviceCollateSpec(
                n_pad=pick_bucket(max(int(host.num_nodes[chunk].sum()), 1),
                                  self.node_buckets),
                e_pad=pick_bucket(max(int(host.num_edges[chunk].sum()), 1),
                                  self.edge_buckets),
                num_graphs=self.batch_size, symmetric=host.symmetric,
                rotate=rotate)
            y = np.zeros((1, self.batch_size) + y_all.shape[1:], np.float32)
            y[0, :len(chunk)] = y_all[chunk]
            graph_mask = np.zeros((1, self.batch_size), np.float32)
            graph_mask[0, :len(chunk)] = 1.0
            yield ('ids', ids, store, spec), BatchMeta(
                [host.lig_fnames[i] for i in chunk],
                [host.rec_fnames[i] for i in chunk], y, graph_mask, chunk)

    def _produce(self) -> Iterator[Tuple[AnyBatch, BatchMeta]]:
        indices = self._epoch_indices()
        if self.device_store is not None:
            yield from self._produce_ids(indices)
            return
        for chunk in self._chunks(indices):
            samples = [self.dataset[int(i)] for i in chunk]
            batch = self._collate(chunk, samples)
            yield batch, BatchMeta([s.lig_fname for s in samples],
                                   [s.rec_fname for s in samples],
                                   batch.y, batch.graph_mask, chunk)

    def _apply_transfer(self, item):
        """``(transfer_fn(batch), meta)``, or the item as it is without a
        ``transfer_fn``."""
        if self.transfer_fn is None:
            return item
        batch, meta = item
        return self.transfer_fn(batch), meta

    def _prefetched(self, cache=None) -> Iterator[Tuple[AnyBatch,
                                                         BatchMeta]]:
        """The produced batches, collated and transferred by one producer
        thread; each host item is also appended to ``cache`` where given.
        """
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        errors = []
        stop = threading.Event()

        def worker():
            try:
                for item in self._produce():
                    if stop.is_set():
                        return
                    q.put((item, self._apply_transfer(item)))
            except BaseException as exc:   # raised in the consumer
                errors.append(exc)
            finally:
                q.put(done)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                got = q.get()
                if got is done:
                    if errors:
                        raise errors[0]
                    return
                if cache is not None:
                    cache.append(got[0])
                yield got[1]
        finally:
            # A consumer that stops early lets the producer finish.
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass

    def __iter__(self) -> Iterator[Tuple[AnyBatch, BatchMeta]]:
        if self.mode == 'train':
            # The ligand side of a pair keeps epoch 0, as in the
            # reference, whose loader sets the receptor dataset's alone.
            epoch = self._epochs_started
            self._epochs_started += 1
            self.dataset.set_epoch(epoch)
            if self.device_store is not None:
                # The augmented tail for this epoch before the producer
                # reads the store's sizes; the next epoch's graphs are
                # featurised while this one trains.
                self.device_store.refresh(self.dataset, epoch)
                self.device_store.prefetch_refresh(self.dataset, epoch + 1)
        if self._batch_cache is not None:
            for item in self._batch_cache:
                yield self._apply_transfer(item)
            return
        cache = [] if self._cacheable else None
        if self.prefetch > 0:
            yield from self._prefetched(cache)
        else:
            for item in self._produce():
                if cache is not None:
                    cache.append(item)
                yield self._apply_transfer(item)
        if cache is not None:
            self._batch_cache = cache


def get_data_loader(
        data_root, types_fname=None, batch_size: int = 32,
        mode: str = 'val', compact: bool = True,
        use_atomic_numbers: bool = False, radius: float = 6,
        rot: bool = False, augmented_actives: int = 0,
        min_aug_angle: float = 30, polar_hydrogens: bool = True,
        model_task: str = 'classification', max_active_rms_distance=None,
        min_inactive_rms_distance=None, max_inactive_rms_distance=None,
        fname_suffix: str = 'parquet', edge_radius=None,
        prune: bool = False, estimate_bonds: bool = False,
        p_noise: float = -1, p_remove_entity: float = 0,
        extended_atom_types: bool = False, prefetch: int = 2,
        seed: int = 0, cache_dir=None,
        node_buckets=DEFAULT_NODE_BUCKETS,
        edge_buckets=DEFAULT_EDGE_BUCKETS, bp=None,
        include_strain_info: bool = False,
        layout: str = 'graph',
        dataset_class=PointCloudDataset, shard_index: int = 0,
        num_shards: int = 1, graph_shard: int = 1,
        gp_index: int = 0) -> GraphDataLoader:
    """Dataset + loader with the reference's keywords. Unlike the
    reference, ``rot`` defaults to False (the scoring loader's setting) and
    ``mode`` to ``'val'``. Structures are parquet, PDB, SDF or MOL2 files,
    read by each path's own suffix (``fname_suffix``, the reference's
    ``--input_suffix``, names the receptors it globs for without a types
    file; the port always reads a types file). ``layout='pair'``
    builds two datasets of the same types file and seed, the receptor's
    atoms (bp 1) and the ligand's (bp 0). ``dataset_class`` is
    ``PointCloudDataset`` or ``SynthPharmDataset`` (``--synthpharm``).
    ``shard_index`` / ``num_shards`` / ``graph_shard`` / ``gp_index``
    place the loader on one rank of a mesh (see the module's
    docstring)."""
    del fname_suffix

    def make_dataset(bp_filter):
        return dataset_class(
            data_root, types_fname, radius=radius,
            polar_hydrogens=polar_hydrogens,
            use_atomic_numbers=use_atomic_numbers, compact=compact, rot=rot,
            augmented_active_count=augmented_actives,
            augmented_active_min_angle=min_aug_angle,
            max_active_rms_distance=max_active_rms_distance,
            min_inactive_rms_distance=min_inactive_rms_distance,
            max_inactive_rms_distance=max_inactive_rms_distance,
            model_task=model_task, edge_radius=edge_radius,
            estimate_bonds=estimate_bonds, prune=prune,
            p_remove_entity=p_remove_entity,
            extended_atom_types=extended_atom_types, p_noise=p_noise,
            bp=bp_filter, include_strain_info=include_strain_info,
            cache_dir=cache_dir, seed=seed)

    paired = None
    if layout == 'pair':
        dataset, paired = make_dataset(1), make_dataset(0)
    else:
        dataset = make_dataset(bp)
    return GraphDataLoader(dataset, batch_size=batch_size, mode=mode,
                           prefetch=prefetch, seed=seed,
                           node_buckets=node_buckets,
                           edge_buckets=edge_buckets, layout=layout,
                           paired_dataset=paired, shard_index=shard_index,
                           num_shards=num_shards, graph_shard=graph_shard,
                           gp_index=gp_index)
