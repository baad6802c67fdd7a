"""Sequential scoring loader (counterpart of the evaluation path of
``pointvs_tpu/data/loader.py``).

Yields ``(GraphBatch, BatchMeta)`` with ``batch_size`` graph slots per
batch, in types-file order; a short last batch leaves its spare slots
empty (``graph_mask == 0``), as the reference's single-device collation
does. Batches stay on the host; ``data.buckets.to_device`` moves them.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from pointvs_tpu_torch.data.buckets import GraphBatch, pad_graphs_to_batch
from pointvs_tpu_torch.data.dataset import PointCloudDataset


class BatchMeta:
    """Host metadata for one batch; filenames line up with graph slots."""

    __slots__ = ('lig_fnames', 'rec_fnames', 'y', 'graph_mask')

    def __init__(self, lig_fnames: List[str], rec_fnames: List[str], y,
                 graph_mask):
        self.lig_fnames = lig_fnames
        self.rec_fnames = rec_fnames
        self.y = y
        self.graph_mask = graph_mask


class ScoringLoader:
    """Iterable over (GraphBatch, BatchMeta) pairs, in dataset order."""

    def __init__(self, dataset: PointCloudDataset, batch_size: int = 32):
        self.dataset = dataset
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[Tuple[GraphBatch, BatchMeta]]:
        for start in range(0, len(self.dataset), self.batch_size):
            samples = [self.dataset[i] for i in range(
                start, min(start + self.batch_size, len(self.dataset)))]
            batch = pad_graphs_to_batch(samples, num_graphs=self.batch_size)
            yield batch, BatchMeta([s.lig_fname for s in samples],
                                   [s.rec_fname for s in samples],
                                   np.asarray(batch.y),
                                   np.asarray(batch.graph_mask))


def get_data_loader(data_root, types_fname, batch_size: int = 32,
                    mode: str = 'val', **dataset_kwargs) -> ScoringLoader:
    """Dataset + loader for scoring (``mode='val'``). Training loaders
    (weighted sampling, rotation, augmentation) come with the training
    slice (ROADMAP.md, Queue 1)."""
    if mode != 'val':
        raise NotImplementedError(
            f"mode={mode!r}: only mode='val' is in the port yet (training "
            f"loaders: see ROADMAP.md, Queue 1)")
    return ScoringLoader(PointCloudDataset(data_root, types_fname,
                                           **dataset_kwargs),
                         batch_size=batch_size)
