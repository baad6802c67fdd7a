"""Structure -> graph preprocessing on the host (numpy).

Own copy of the numpy semantics of the reference's
``pointvs_tpu/data/preprocessing.py`` (and its struct-dict fast path,
``data/fast_structs.py``). A "struct" is a dict of numpy columns with the
parquet schema keys ``x, y, z, atomic_number, types, bp`` (bp 0 = ligand,
1 = receptor).

- ``read_structure``: a parquet file, or a PDB/SDF/MOL2 file typed by
  ``dataset_generation/types_to_parquet.StructuralFileParser``.
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
- Both go through the port's g++ library (``native/build.py``: a cell
  grid, no [n, n] matrix); ``make_box_numpy`` and
  ``generate_edges_numpy`` are their plain versions over dense distance
  matrices, equal to them array for array (rows, order, edge classes,
  the pruned atoms).
- ``make_bit_vector``: compact one-hot + receptor/ligand bit featurisation.
- ``uniform_random_rotation`` / ``rotate_struct``: rotations drawn from a
  caller's ``RandomState`` in the reference's draw order, so seeded streams
  give the reference's rotations bit for bit.
- Synthetic pharmacophores (``SynthPharmDataset``): ``read_synthpharm``
  reads a file's ``x, y, z, type`` (and ``bp`` where it has one);
  ``concat_synthpharm`` gives each atom an ``atom_id`` (a ligand atom's
  atomic number among ``SYNTH_PHARM_ATOMIC_NUMBERS`` -> 3..11, a receptor
  atom's own ``type``, 0..2); ``generate_edges(synthpharm=True)`` takes the
  entity from it (``bp`` = ``atom_id <= 2``).
"""
from __future__ import annotations

import os
from collections import defaultdict
from functools import lru_cache
from typing import Dict

import numpy as np

from pointvs_tpu_torch.native import build as native

KEYS = ('x', 'y', 'z', 'atomic_number', 'types', 'bp')
SYNTH_PHARM_KEYS = ('x', 'y', 'z', 'type', 'bp')
SYNTH_PHARM_ATOMIC_NUMBERS = (6, 7, 8, 9, 15, 16, 17, 35, 53)
Struct = Dict[str, np.ndarray]


def read_struct(path) -> Struct:
    """Parquet structure file -> struct dict. Cached per (path, size,
    mtime): augmented items re-read their files every epoch. Treat the
    arrays as read-only."""
    path = str(path)
    st = os.stat(path)
    return _read_struct_cached(path, (st.st_size, st.st_mtime_ns), KEYS)


def read_synthpharm(path) -> Struct:
    """A synthetic-pharmacophore parquet -> its ``x, y, z, type`` columns,
    and ``bp`` where the file has it; cached as ``read_struct``."""
    import pyarrow.parquet as pq
    path = str(path)
    st = os.stat(path)
    names = set(pq.ParquetFile(path).schema_arrow.names)
    keys = tuple(k for k in SYNTH_PHARM_KEYS if k in names)
    return _read_struct_cached(path, (st.st_size, st.st_mtime_ns), keys)


def read_structure(path, mol_type: str, extended: bool = False) -> Struct:
    """A parquet file's struct (``read_struct``), or a PDB/SDF/MOL2 file's
    first molecule smina-typed by ``StructuralFileParser`` (``mol_type``
    'ligand' or 'receptor'), cached as ``read_struct``."""
    path = str(path)
    if path.rsplit('.', 1)[-1] == 'parquet':
        return read_struct(path)
    st = os.stat(path)
    return _parse_cached(path, (st.st_size, st.st_mtime_ns), mol_type,
                         extended)


@lru_cache(maxsize=4096)
def _parse_cached(path: str, _fingerprint, mol_type: str,
                  extended: bool) -> Struct:
    from pointvs_tpu_torch.dataset_generation.types_to_parquet import \
        StructuralFileParser
    frame = StructuralFileParser(mol_type, extended).file_to_parquets(
        path, add_polar_hydrogens=True)
    return {k: frame[k].to_numpy() for k in KEYS}


@lru_cache(maxsize=4096)
def _read_struct_cached(path: str, _fingerprint, keys) -> Struct:
    import pyarrow.parquet as pq
    table = pq.ParquetFile(path).read(columns=list(keys), use_threads=False)
    return {k: table.column(k).to_numpy() for k in keys}


def subset(struct: Struct, mask_or_idx) -> Struct:
    return {k: v[mask_or_idx] for k, v in struct.items()}


def coords_of(struct: Struct) -> np.ndarray:
    return np.stack([struct['x'], struct['y'], struct['z']], axis=1)


def concat_structs(rec: Struct, lig: Struct, n_features: int,
                   extended: bool = False) -> Struct:
    rec_types = rec['types'] + (n_features + 8 * int(extended))
    return {k: np.concatenate([lig[k], rec_types if k == 'types' else rec[k]])
            for k in KEYS}


def concat_synthpharm(rec: Struct, lig: Struct) -> Struct:
    """Ligand rows then receptor rows of the columns both files have, with
    ``atom_id``: 3 + the index of a ligand atom's ``type`` (an atomic
    number) in ``SYNTH_PHARM_ATOMIC_NUMBERS``, and a receptor atom's
    ``type``."""
    lookup = np.full(max(SYNTH_PHARM_ATOMIC_NUMBERS) + 1, -1, np.int64)
    lookup[list(SYNTH_PHARM_ATOMIC_NUMBERS)] = np.arange(
        3, 3 + len(SYNTH_PHARM_ATOMIC_NUMBERS))
    lig_types = np.asarray(lig['type'], np.int64)
    known = (lig_types >= 0) & (lig_types < len(lookup))
    lig_ids = np.where(known, lookup[np.where(known, lig_types, 0)], -1)
    if (lig_ids < 0).any():
        raise ValueError(
            f'synthetic-pharmacophore ligand types must be among the atomic '
            f'numbers {SYNTH_PHARM_ATOMIC_NUMBERS}, got '
            f'{sorted(set(lig_types[lig_ids < 0].tolist()))}')
    out = {k: np.concatenate([lig[k], rec[k]]) for k in lig if k in rec}
    out['atom_id'] = np.concatenate(
        [lig_ids, np.asarray(rec['type'], np.int64)])
    return out


def random_rotation_matrix(rng) -> np.ndarray:
    """Rotation drawn uniformly over SO(3) (Arvo's fast random rotation
    matrices, 1992): a random z rotation reflected through a random
    Householder plane. Three draws from ``rng``, in the order x2, x3,
    theta."""
    x2 = 2 * np.pi * rng.rand()
    x3 = rng.rand()
    theta = 2 * np.pi * rng.rand()
    ct, st = np.cos(theta), np.sin(theta)
    s3 = np.sqrt(x3)
    vx, vy, vz = np.cos(x2) * s3, np.sin(x2) * s3, np.sqrt(1 - x3)
    # -(householder @ rot_z), householder = I - 2 v v^T
    h00, h01, h02 = 1 - 2 * vx * vx, -2 * vx * vy, -2 * vx * vz
    h11, h12 = 1 - 2 * vy * vy, -2 * vy * vz
    h22 = 1 - 2 * vz * vz
    return -np.array([
        [h00 * ct + h01 * st, -h00 * st + h01 * ct, h02],
        [h01 * ct + h11 * st, -h01 * st + h11 * ct, h12],
        [h02 * ct + h12 * st, -h02 * st + h12 * ct, h22],
    ])


def uniform_random_rotation(x: np.ndarray, rng) -> np.ndarray:
    """[N, 3] points times a uniformly drawn rotation (float64). Rotating
    about the centroid and translating the centroid through the same
    rotation, as PointVS does, is just ``x @ m``."""
    return np.asarray(x).reshape((-1, 3)) @ random_rotation_matrix(rng)


def angle_3d(v1: np.ndarray, v2: np.ndarray) -> float:
    """Angle between two 3-vectors (the first rows of matrices)."""
    v1 = np.asarray(v1, dtype=np.float64).reshape((-1, 3))
    v2 = np.asarray(v2, dtype=np.float64).reshape((-1, 3))
    dot = float(np.einsum('ij,ij->i', v1, v2)[0])
    denom = max(1e-7, float(np.linalg.norm(v1) * np.linalg.norm(v2)))
    return float(np.arccos(np.clip(dot / denom, -1.0, 1.0)))


def rotate_struct(struct: Struct, min_angle_deg: float, rng) -> Struct:
    """A copy whose coordinates are rotated, redrawn until the first atom's
    position vector has turned by at least ``min_angle_deg`` (the
    augmented actives' ligand rotation)."""
    min_rads = np.pi * min_angle_deg / 180
    initial = coords_of(struct)
    candidate = initial
    while angle_3d(initial[0, :], candidate[0, :]) < min_rads:
        candidate = uniform_random_rotation(initial, rng)
    out = dict(struct)
    for j, key in enumerate('xyz'):
        out[key] = np.ascontiguousarray(candidate[:, j])
    return out


def _pairwise_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    diff = a[:, None, :] - b[None, :, :]
    return np.sqrt(np.einsum('ijk,ijk->ij', diff, diff))


def _box_rows(struct: Struct, radius: float, rec_near) -> np.ndarray:
    """The rows ``make_box`` keeps: every ligand row, then the receptor
    rows ``rec_near(lig_xyz, rec_xyz, radius)`` selects (positions into the
    receptor rows)."""
    bp = struct['bp']
    lig_idx = np.flatnonzero(bp == 0)
    rec_idx = np.flatnonzero(bp == 1)
    if len(lig_idx) and len(rec_idx):
        xyz = coords_of(struct)
        rec_idx = rec_idx[rec_near(xyz[lig_idx], xyz[rec_idx], radius)]
    elif not len(lig_idx):
        rec_idx = rec_idx[:0]
    return np.concatenate([lig_idx, rec_idx])


def _near_numpy(lig_xyz, rec_xyz, radius) -> np.ndarray:
    return np.flatnonzero(
        (_pairwise_distances(lig_xyz, rec_xyz) < radius).any(axis=0))


def make_box(struct: Struct, radius: float) -> Struct:
    """Every ligand atom, then the receptor atoms strictly within
    ``radius`` of any ligand atom, in their original order (the native
    box filter)."""
    return subset(struct, _box_rows(struct, radius, native.box_filter))


def make_box_numpy(struct: Struct, radius: float) -> Struct:
    """``make_box``'s plain version: the dense [n_lig, n_rec] distances."""
    return subset(struct, _box_rows(struct, radius, _near_numpy))


def _entity_bp(struct: Struct, synthpharm: bool) -> Struct:
    if synthpharm:
        return dict(struct, bp=(struct['atom_id'] <= 2).astype(np.int64))
    return struct


def generate_edges(struct: Struct, inter_radius: float = 4.0,
                   intra_radius: float = 2.0, prune: bool = True,
                   synthpharm: bool = False):
    """-> (struct, rows, cols, attrs); struct loses pruned atoms. With
    ``synthpharm`` the entity ``bp`` is ``atom_id <= 2`` (the receptor's
    ids), in the struct returned too. The native library's cell grid;
    equal, array for array, to ``generate_edges_numpy``."""
    struct = _entity_bp(struct, synthpharm)
    rows, cols, attrs, keep = native.radius_edges(
        coords_of(struct), struct['bp'], inter_radius, intra_radius, prune)
    if not keep.all():
        struct = subset(struct, keep)
    return struct, rows, cols, attrs


def generate_edges_numpy(struct: Struct, inter_radius: float = 4.0,
                         intra_radius: float = 2.0, prune: bool = True,
                         synthpharm: bool = False):
    """``generate_edges``' plain version, over the dense [n, n] distance
    matrix."""
    struct = _entity_bp(struct, synthpharm)
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
            return generate_edges_numpy(subset(struct, keep), inter_radius,
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
