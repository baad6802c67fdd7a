"""The screening dataset: one receptor's work shared by a whole library.

Counterpart of ``pointvs_tpu/data/shared_receptor.py``. In a screen every
item pairs the same receptor with another ligand, and the standard
pipeline (``PointCloudDataset._build_graph``) redoes per pose the pocket
box over every receptor atom and a radius search whose pairs are mostly
receptor-receptor. ``SharedReceptorDataset`` does these once a receptor:

- the receptor (after the hydrogen filter) and all its receptor-receptor
  edges within the intra radius, kept sorted by row with offsets. Radius
  edges are pairwise, so a pocket's receptor-receptor edges are exactly
  the full list restricted to the pocket's atoms;
- a uniform 4 Å cell grid over the receptor's atoms, for the pocket
  selection (over all atoms: the standard path boxes before the hydrogen
  filter) and the ligand-receptor pairs (over the filtered atoms).

Per pose only ligand-sized work remains: grid queries for the pocket and
the ligand-receptor pairs, the ligand-ligand block, and the restriction
of the receptor's edge list. The graph equals the standard pipeline's,
its intra-block duplicate edges included (``preprocessing.generate_edges``),
in the same (sender, receiver) order (a stable lexical sort, as
``PointCloudDataset._edges_for``).

Configurations whose graph is not pairwise fall back to the standard
pipeline item by item: an augmented (rotated) ligand, the ``bp`` entity
filter, pruning, ``edge_radius < 0`` and the whole-complex rotation
``rot``; so do non-parquet files. The receptor's precomputation is cached
per process by its path, its size and modification time, the hydrogen
setting and the intra radius.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from pointvs_tpu_torch.data.dataset import PointCloudDataset
from pointvs_tpu_torch.data.preprocessing import concat_structs, \
    read_struct, subset

_CELL = 4.0   # Å, the grids' cell edge


class _RecGrid:
    """A uniform cell grid over receptor coordinates (built once)."""

    def __init__(self, xyz: np.ndarray, cell: float):
        self.xyz = xyz
        self.cell = float(max(cell, 1e-6))
        keys = np.floor(xyz / self.cell).astype(np.int64)
        self.min_key = keys.min(axis=0) if len(keys) else np.zeros(
            3, np.int64)
        k = keys - self.min_key
        self.dims = (k.max(axis=0) + 1) if len(k) else np.ones(3, np.int64)
        flat = (k[:, 0] * self.dims[1] + k[:, 1]) * self.dims[2] + k[:, 2]
        order = np.argsort(flat, kind='stable')
        self.sorted_idx = order.astype(np.int64)
        self.sorted_flat = flat[order]

    def pairs(self, points: np.ndarray, radius: float):
        """(point index, receptor index, squared distance) of every pair
        closer than ``radius``: each point's neighbouring cells are looked
        up in one ``searchsorted`` batch and measured in one pass."""
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
        if not len(self.xyz) or not len(points):
            return empty
        reach = int(np.ceil(radius / self.cell))
        span = np.arange(-reach, reach + 1)
        offsets = np.stack(np.meshgrid(span, span, span, indexing='ij'),
                           axis=-1).reshape(-1, 3)
        k = np.floor(points / self.cell).astype(np.int64) - self.min_key
        cells = k[:, None, :] + offsets[None, :, :]          # [P, M, 3]
        valid = np.all((cells >= 0) & (cells < self.dims), axis=-1)
        owners = np.broadcast_to(
            np.arange(len(points), dtype=np.int64)[:, None], valid.shape)
        cells, owners = cells[valid], owners[valid]
        flat = ((cells[:, 0] * self.dims[1] + cells[:, 1]) * self.dims[2]
                + cells[:, 2])
        lo = np.searchsorted(self.sorted_flat, flat, side='left')
        hi = np.searchsorted(self.sorted_flat, flat, side='right')
        counts = hi - lo
        total = int(counts.sum())
        if not total:
            return empty
        starts = np.repeat(np.cumsum(counts) - counts, counts)
        pos = np.arange(total, dtype=np.int64) - starts + np.repeat(lo,
                                                                     counts)
        cand = self.sorted_idx[pos]
        owner = np.repeat(owners, counts)
        diff = self.xyz[cand] - points[owner]
        d2 = np.einsum('ij,ij->i', diff, diff)
        keep = d2 < radius * radius
        return owner[keep], cand[keep], d2[keep]

    def query(self, points: np.ndarray, radius: float) -> np.ndarray:
        """Sorted indices of the receptor atoms closer than ``radius`` to
        any of ``points``."""
        return np.unique(self.pairs(points, radius)[1])


def _xyz(struct) -> np.ndarray:
    return np.stack([struct['x'], struct['y'], struct['z']],
                    axis=1).astype(np.float64)


def _all_pairs_within(xyz: np.ndarray, grid: _RecGrid, radius: float):
    """Every ordered pair (i != j) at a distance in (1e-7, radius)."""
    pi, ri, d2 = grid.pairs(xyz, radius)
    keep = (pi != ri) & (d2 > 1e-14)
    return pi[keep], ri[keep], d2[keep]


class _SharedReceptor:
    """The once-a-receptor precomputation."""

    def __init__(self, rec_struct: Dict[str, np.ndarray],
                 polar_hydrogens: bool, intra_radius: float):
        all_xyz = _xyz(rec_struct)
        if polar_hydrogens:
            self.f_of_all = np.arange(len(all_xyz))
            self.rec_f = rec_struct
        else:
            keep = rec_struct['atomic_number'] > 1
            self.f_of_all = np.cumsum(keep) - 1     # all index -> filtered
            self.f_of_all[~keep] = -1
            self.rec_f = subset(rec_struct, keep)
        f_xyz = _xyz(self.rec_f)
        self.grid_all = _RecGrid(all_xyz, cell=_CELL)
        self.grid_f = _RecGrid(f_xyz, cell=_CELL)
        # The filtered receptor's own edges, sorted by row, with offsets,
        # so a pocket gathers only its rows' slices.
        rows, cols, _ = _all_pairs_within(f_xyz, self.grid_f, intra_radius)
        order = np.argsort(rows, kind='stable')
        self.rr_rows = rows[order].astype(np.int64)
        self.rr_cols = cols[order].astype(np.int64)
        counts = np.bincount(self.rr_rows, minlength=len(f_xyz))
        self.rr_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)

    def rr_restrict(self, sel_f: np.ndarray, inv: np.ndarray):
        """The pocket's receptor-receptor edges (rows, cols) in
        pocket-local indices, from the selected rows' slices."""
        lo = self.rr_offsets[sel_f]
        counts = self.rr_offsets[sel_f + 1] - lo
        total = int(counts.sum())
        if not total:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        starts = np.repeat(np.cumsum(counts) - counts, counts)
        pos = np.arange(total, dtype=np.int64) - starts + np.repeat(lo,
                                                                     counts)
        rows, cols = self.rr_rows[pos], inv[self.rr_cols[pos]]
        keep = cols >= 0
        return inv[rows[keep]], cols[keep]


class SharedReceptorDataset(PointCloudDataset):
    """``PointCloudDataset`` with the shared-receptor fast path (see the
    module docstring); items it cannot reproduce exactly take the
    standard pipeline."""

    _shared_cache: Dict[tuple, _SharedReceptor] = {}

    def _fast_path_ok(self, aug_angle: float) -> bool:
        return (not aug_angle and self.bp is None and not self.prune
                and self.edge_radius >= 0 and not self.rot)

    def _radii(self):
        edge_radius = self.edge_radius if self.edge_radius > 0 else 4
        return edge_radius, 2.0 if self.estimate_bonds else edge_radius

    def _shared_for(self, rec_path) -> _SharedReceptor:
        intra_radius = self._radii()[1]
        st = os.stat(rec_path)
        key = (str(rec_path), st.st_size, st.st_mtime_ns,
               bool(self.polar_hydrogens), float(intra_radius))
        if key not in self._shared_cache:
            self._shared_cache[key] = _SharedReceptor(
                read_struct(rec_path), self.polar_hydrogens, intra_radius)
        return self._shared_cache[key]

    def _build_graph(self, lig_path, rec_path, aug_angle: float = 0,
                     rng=None):
        if (not self._fast_path_ok(aug_angle)
                or str(lig_path).rsplit('.', 1)[-1] != 'parquet'
                or str(rec_path).rsplit('.', 1)[-1] != 'parquet'):
            return super()._build_graph(lig_path, rec_path, aug_angle,
                                        rng=rng)
        shared = self._shared_for(rec_path)
        lig_all = read_struct(lig_path)

        # The pocket over all atoms (the standard path boxes before the
        # hydrogen filter), then the filter on both sides.
        sel_all = shared.grid_all.query(_xyz(lig_all), self.radius)
        if self.polar_hydrogens:
            lig, sel_f = lig_all, sel_all
        else:
            lig = subset(lig_all, lig_all['atomic_number'] > 1)
            sel_f = shared.f_of_all[sel_all]
            sel_f = sel_f[sel_f >= 0]
        rec_sub = subset(shared.rec_f, sel_f)

        # The pocket struct: ligand rows first, receptor types offset.
        n_lig = len(lig['bp'])
        struct = concat_structs(rec_sub, lig, self.n_features,
                                extended=self.extended_atom_types)
        if self.use_atomic_numbers:
            z = np.minimum(struct['atomic_number'], 129)
            struct = dict(struct, types=self._z_lut[z]
                          + struct['bp'] * self.n_features)

        edge_radius, intra_radius = self._radii()
        lig_xyz = _xyz(lig)
        # Ligand-receptor pairs against the filtered receptor once, at the
        # larger radius, kept where the receptor atom is in the pocket.
        li, ri_f, d2 = shared.grid_f.pairs(lig_xyz,
                                           max(edge_radius, intra_radius))
        inv = np.full(len(shared.rec_f['bp']), -1, np.int64)
        inv[sel_f] = np.arange(len(sel_f))
        in_pocket = inv[ri_f] >= 0
        li, d2 = li[in_pocket], d2[in_pocket]
        rj = inv[ri_f[in_pocket]] + n_lig
        nontrivial = d2 > 1e-14

        rows, cols, attrs = [], [], []

        def emit(r, c, cls):
            rows.append(r)
            cols.append(c)
            attrs.append(np.full(len(r), cls, np.int64))

        # Inter block: class 1, both directions, closer than edge_radius.
        m = (d2 < edge_radius ** 2) & nontrivial
        emit(li[m], rj[m], 1)
        emit(rj[m], li[m], 1)
        # Intra block, not filtered by molecule (the reference's
        # duplicates): ligand-ligand and ligand-receptor both ways class
        # 0, receptor-receptor class 2 from the receptor's own list.
        ld = lig_xyz[:, None, :] - lig_xyz[None, :, :]
        ld2 = np.einsum('ijk,ijk->ij', ld, ld)
        ii, jj = np.where((ld2 < intra_radius ** 2) & (ld2 > 1e-14))
        emit(ii.astype(np.int64), jj.astype(np.int64), 0)
        m = (d2 < intra_radius ** 2) & nontrivial
        emit(li[m], rj[m], 0)
        emit(rj[m], li[m], 0)
        rr_r, rr_c = shared.rr_restrict(sel_f, inv)
        emit(rr_r + n_lig, rr_c + n_lig, 2)

        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        attrs = np.concatenate(attrs)
        order = np.lexsort((cols, rows))   # stable: by row, then column
        onehot = np.zeros((len(order), 3), np.float32)
        onehot[np.arange(len(order)), attrs[order]] = 1.0
        return (struct, rows[order].astype(np.int32),
                cols[order].astype(np.int32), onehot)

