"""Structure -> graph preprocessing on the host (numpy).

Own copy of the numpy semantics of the reference's
``pointvs_tpu/data/preprocessing.py`` (and its struct-dict fast path,
``data/fast_structs.py``). A "struct" is a dict of numpy columns with the
parquet schema keys ``x, y, z, atomic_number, types, bp`` (bp 0 = ligand,
1 = receptor).

- ``concat_structs``: ligand rows first, receptor types offset by
  ``n_features`` (+8 with extended typing).
- ``make_box``: keep every ligand atom plus the receptor atoms strictly
  within ``radius`` of any ligand atom, in their original order.
- ``generate_edges``: radius graph in two blocks, inter-molecular pairs
  closer than ``inter_radius`` (class 1), then ALL pairs closer than
  ``intra_radius`` (class 2 if both receptor, else 0; not filtered by
  molecule, which reproduces the reference's duplicate edges when the radii
  overlap); optional pruning of atoms not connected to the first
  inter-molecular edge's source.
- ``make_bit_vector``: compact one-hot + receptor/ligand bit featurisation.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np

KEYS = ('x', 'y', 'z', 'atomic_number', 'types', 'bp')
Struct = Dict[str, np.ndarray]


def read_struct(path) -> Struct:
    """Parquet structure file -> struct dict."""
    import pyarrow.parquet as pq
    table = pq.ParquetFile(str(path)).read(columns=list(KEYS),
                                           use_threads=False)
    return {k: table.column(k).to_numpy() for k in KEYS}


def subset(struct: Struct, mask_or_idx) -> Struct:
    return {k: v[mask_or_idx] for k, v in struct.items()}


def coords_of(struct: Struct) -> np.ndarray:
    return np.stack([struct['x'], struct['y'], struct['z']], axis=1)


def concat_structs(rec: Struct, lig: Struct, n_features: int,
                   extended: bool = False) -> Struct:
    rec_types = rec['types'] + (n_features + 8 * int(extended))
    return {k: np.concatenate([lig[k], rec_types if k == 'types' else rec[k]])
            for k in KEYS}


def _pairwise_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    diff = a[:, None, :] - b[None, :, :]
    return np.sqrt(np.einsum('ijk,ijk->ij', diff, diff))


def make_box(struct: Struct, radius: float) -> Struct:
    bp = struct['bp']
    lig_idx = np.where(bp == 0)[0]
    rec_idx = np.where(bp == 1)[0]
    if len(lig_idx) and len(rec_idx):
        xyz = coords_of(struct)
        near = (_pairwise_distances(xyz[lig_idx], xyz[rec_idx])
                < radius).any(axis=0)
        rec_idx = rec_idx[near]
    elif not len(lig_idx):
        rec_idx = rec_idx[:0]
    return subset(struct, np.concatenate([lig_idx, rec_idx]))


def generate_edges(struct: Struct, inter_radius: float = 4.0,
                   intra_radius: float = 2.0, prune: bool = True):
    """-> (struct, rows, cols, attrs); struct loses pruned atoms."""
    coords = coords_of(struct).astype(np.float64)
    bp = struct['bp']
    dists = _pairwise_distances(coords, coords)
    nontrivial = dists > 1e-7

    inter_i, inter_j = np.where((dists < inter_radius) & nontrivial)
    mixed = bp[inter_i] != bp[inter_j]
    inter_i, inter_j = inter_i[mixed], inter_j[mixed]

    intra_i, intra_j = np.where((dists < intra_radius) & nontrivial)
    intra_attrs = np.where((bp[intra_i] == 1) & (bp[intra_j] == 1), 2, 0)

    rows = np.concatenate([inter_i, intra_i])
    cols = np.concatenate([inter_j, intra_j])
    attrs = np.concatenate([np.ones(len(inter_i), np.int64),
                            intra_attrs]).astype(np.int32)

    if prune and len(inter_i):
        adjacency = defaultdict(list)
        for a, b in zip(rows, cols):
            adjacency[a].append(b)
            adjacency[b].append(a)
        seen = {rows[0]}
        frontier = [rows[0]]
        while frontier:
            for child in adjacency[frontier.pop()]:
                if child not in seen:
                    seen.add(child)
                    frontier.append(child)
        keep = np.array(sorted(seen))
        if len(keep) < len(bp):
            return generate_edges(subset(struct, keep), inter_radius,
                                  intra_radius, prune=False)
    return struct, rows, cols, attrs


def make_bit_vector(atom_types: np.ndarray, n_atom_types: int,
                    compact: bool = True) -> np.ndarray:
    """compact: ``n_atom_types + 1`` columns, one-hot of
    ``types % n_atom_types`` with the last column set to the entity bit
    ``types // n_atom_types``; else one-hot over ``2 * n_atom_types``."""
    atom_types = np.asarray(atom_types, dtype=np.int64)
    rows = np.arange(len(atom_types))
    if compact:
        onehot = np.zeros((len(atom_types), n_atom_types + 1), np.float32)
        onehot[rows, atom_types % n_atom_types] = 1.0
        onehot[:, -1] = (atom_types // n_atom_types).astype(np.float32)
    else:
        onehot = np.zeros((len(atom_types), n_atom_types * 2), np.float32)
        onehot[rows, atom_types] = 1.0
    return onehot
