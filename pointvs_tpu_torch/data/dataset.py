"""Host-side dataset: types manifest -> GraphSamples, for scoring.

Counterpart of the evaluation path of ``pointvs_tpu/data/dataset.py``
(``PointCloudDataset`` in ``mode='val'``): labels straight from the types
file, smina-type or atomic-number featurisation with the compact
one-hot + entity-bit scheme, box filter, radius graph with inter/intra
radii (``estimate_bonds`` => intra 2.0 A) and optional pruning. Edges are
sorted by (sender, receiver), stably, as the reference sorts them.
Augmentation, rotation and the on-disk graph cache are training features
and are not here.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from pointvs_tpu_torch.data.buckets import GraphSample
from pointvs_tpu_torch.data.preprocessing import (
    concat_structs,
    coords_of,
    generate_edges,
    make_bit_vector,
    make_box,
    read_struct,
    subset,
)
from pointvs_tpu_torch.data.types_files import (
    parse_classification_types,
    parse_regression_types,
)
from pointvs_tpu_torch.utils import expand_path

_RECOGNISED_ATOMIC_NUMBERS = (6, 7, 8, 9, 15, 16, 17)
_OTHER_GROUPINGS = ((35, 53), (3, 11, 19), (4, 12, 20), (26, 29, 30))


def build_atomic_number_map(polar_hydrogens: bool):
    """Atomic number -> feature index (unmapped elements -> n_features)."""
    mapping = {num: idx for idx, num in enumerate(_RECOGNISED_ATOMIC_NUMBERS)}
    for grouping in _OTHER_GROUPINGS:
        nxt = max(mapping.values()) + 1
        mapping.update({elem: nxt for elem in grouping})
    if polar_hydrogens:
        mapping[1] = max(mapping.values()) + 1
    n_features = max(mapping.values()) + 1
    lookup = defaultdict(lambda: n_features)
    lookup.update(mapping)
    return lookup, n_features


class PointCloudDataset:
    """Map-style dataset of protein-ligand complexes as graphs."""

    def __init__(self, base_path, types_fname, radius: float = 12,
                 polar_hydrogens: bool = True,
                 use_atomic_numbers: bool = False, compact: bool = True,
                 model_task: str = 'classification',
                 edge_radius: float | None = None,
                 estimate_bonds: bool = False, prune: bool = False,
                 extended_atom_types: bool = False):
        self.base_path = expand_path(base_path)
        if not self.base_path.exists():
            raise FileNotFoundError(f'Dataset {self.base_path} does not '
                                    f'exist.')
        self.radius = radius
        self.polar_hydrogens = polar_hydrogens
        self.use_atomic_numbers = use_atomic_numbers
        self.compact = compact
        self.model_task = model_task
        self.edge_radius = edge_radius if edge_radius is not None else 4.0
        self.estimate_bonds = estimate_bonds
        self.prune = prune
        self.extended_atom_types = extended_atom_types

        if model_task.endswith('regression'):
            entries = parse_regression_types(self.base_path, types_fname)
            self.targets = list(zip(entries.pki, entries.pkd, entries.ic50))
            self.labels = None
        else:
            entries = parse_classification_types(types_fname)
            self.labels = np.array([-1 if l is None else l
                                    for l in entries.labels], np.int64)
        self.receptor_fnames = entries.receptors
        self.ligand_fnames = entries.ligands

        self._z_lut = None
        if use_atomic_numbers:
            lookup, self.n_features = build_atomic_number_map(
                polar_hydrogens)
            self._z_lut = np.full(130, self.n_features, np.int64)
            for z, idx in dict(lookup).items():
                if z < 130:
                    self._z_lut[z] = idx
        elif polar_hydrogens:
            raise NotImplementedError('Hydrogens temporarily disabled.')
        else:
            self.n_features = 11 + 8 * extended_atom_types

    def __len__(self):
        return len(self.ligand_fnames)

    def _label_for(self, item: int):
        if self.model_task == 'classification':
            return np.float32(self.labels[item])
        pki, pkd, ic50 = self.targets[item]
        if self.model_task == 'multi_regression':
            return np.array([pki, pkd, ic50], np.float32)
        vals = [v for v in (pki, pkd, ic50) if v is not None]
        return np.float32(max(vals) if vals else 0.0)

    def _build_struct(self, lig_path, rec_path):
        struct = make_box(concat_structs(read_struct(rec_path),
                                         read_struct(lig_path),
                                         self.n_features,
                                         extended=self.extended_atom_types),
                          radius=self.radius)
        if not self.polar_hydrogens:
            struct = subset(struct, struct['atomic_number'] > 1)
        if self.use_atomic_numbers:
            z = np.minimum(struct['atomic_number'], 129)
            struct = dict(struct, types=self._z_lut[z]
                          + struct['bp'] * self.n_features)
        return struct

    def _edges_for(self, struct):
        edge_radius = self.edge_radius if self.edge_radius > 0 else 4
        intra_radius = 2.0 if self.estimate_bonds else edge_radius
        if self.edge_radius < 0:
            empty = np.zeros(0, np.int32)
            return struct, empty, empty, np.zeros((0, 3), np.float32)
        struct, rows, cols, attrs = generate_edges(
            struct, edge_radius, intra_radius, prune=self.prune)
        order = np.lexsort((cols, rows))   # stable: by row, then column
        rows = rows[order].astype(np.int32)
        cols = cols[order].astype(np.int32)
        onehot = np.zeros((len(order), 3), np.float32)
        onehot[np.arange(len(order)), attrs[order]] = 1.0
        return struct, rows, cols, onehot

    def __getitem__(self, item: int) -> GraphSample:
        lig_path = self.base_path / self.ligand_fnames[item]
        rec_path = self.base_path / self.receptor_fnames[item]
        for path in (lig_path, rec_path):
            if not path.is_file():
                raise FileNotFoundError(f'{path} does not exist.')
        struct, rows, cols, edge_attr = self._edges_for(
            self._build_struct(lig_path, rec_path))
        return GraphSample(
            node_feats=make_bit_vector(struct['types'], self.n_features,
                                       self.compact),
            coords=coords_of(struct).astype(np.float32),
            senders=rows, receivers=cols, edge_attr=edge_attr,
            y=self._label_for(item),
            lig_fname=str(lig_path), rec_fname=str(rec_path))
