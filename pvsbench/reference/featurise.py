"""Plain featurisation of one protein-ligand pose, in numpy over dense
distance matrices.

The semantics are PointVS's (github.com/jscant/PointVS,
``point_vs/preprocessing``, ``point_vs/dataset_generation``), written from
its description and not from the program under test:

- the complex is the ligand's rows, then the receptor's, whose smina
  types are shifted by the 11 ligand types;
- the box pocket keeps every ligand atom and each receptor atom strictly
  within ``radius`` of some ligand atom (hydrogens included), in file
  order; hydrogens are then dropped;
- the radius graph is two blocks: pairs of atoms of different molecules
  closer than ``edge_radius`` (edge class 1), then all pairs closer than
  the intra radius (class 2 where both atoms are receptor atoms, else 0).
  ``estimate_bonds`` sets the intra radius to 2.0 A, the length of a
  covalent bond; otherwise it is ``edge_radius``, so that pairs of
  different molecules within it appear twice, once in each class, as in
  PointVS;
- node features are the compact one-hot of the type modulo 11 with the
  molecule bit (0 ligand, 1 receptor) as a twelfth column.
"""
from __future__ import annotations

import numpy as np

N_TYPES = 11
COLUMNS = ('x', 'y', 'z', 'atomic_number', 'types', 'bp')


def read_structure(path) -> dict:
    """A parquet structure file's columns as numpy arrays."""
    import pyarrow.parquet as pq
    table = pq.read_table(str(path), columns=list(COLUMNS))
    return {c: table.column(c).to_numpy() for c in COLUMNS}


def _distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    diff = a[:, None, :] - b[None, :, :]
    return np.sqrt((diff * diff).sum(-1))


def featurise(rec: dict, lig: dict, radius: float, edge_radius: float,
              estimate_bonds: bool) -> dict:
    """-> ``feats`` [n, 12] f32, ``coords`` [n, 3] f32, ``senders``,
    ``receivers`` (int64) and ``eclass`` (int64) of the pose's graph."""
    xyz = np.concatenate([np.stack([lig[c] for c in 'xyz'], 1),
                          np.stack([rec[c] for c in 'xyz'], 1)]
                         ).astype(np.float64)
    types = np.concatenate([lig['types'], rec['types'] + N_TYPES])
    bp = np.concatenate([lig['bp'], rec['bp']])
    z = np.concatenate([lig['atomic_number'], rec['atomic_number']])
    n_lig = len(lig['x'])
    near = (_distances(xyz[:n_lig], xyz[n_lig:]) < radius).any(axis=0)
    keep = np.concatenate([np.arange(n_lig), n_lig + np.flatnonzero(near)])
    keep = keep[z[keep] > 1]
    xyz, types, bp = xyz[keep], types[keep], bp[keep]

    dist = _distances(xyz, xyz)
    apart = dist > 1e-7
    inter_s, inter_r = np.nonzero((dist < edge_radius) & apart
                                  & (bp[:, None] != bp[None, :]))
    intra = 2.0 if estimate_bonds else edge_radius
    intra_s, intra_r = np.nonzero((dist < intra) & apart)
    senders = np.concatenate([inter_s, intra_s])
    receivers = np.concatenate([inter_r, intra_r])
    eclass = np.concatenate([
        np.ones(len(inter_s), np.int64),
        np.where((bp[intra_s] == 1) & (bp[intra_r] == 1), 2, 0)])
    order = np.lexsort((receivers, senders))

    feats = np.zeros((len(types), N_TYPES + 1), np.float32)
    feats[np.arange(len(types)), types % N_TYPES] = 1.0
    feats[:, N_TYPES] = types // N_TYPES
    return dict(feats=feats, coords=xyz.astype(np.float32),
                senders=senders[order].astype(np.int64),
                receivers=receivers[order].astype(np.int64),
                eclass=eclass[order].astype(np.int64))
