"""Host-side dataset: types manifest -> GraphSamples.

Counterpart of ``pointvs_tpu/data/dataset.py`` (``PointCloudDataset``):

- classification labels from the types file, or relabelled by pose RMSD
  with the max_active / min_inactive / max_inactive cut-offs;
- augmented actives: each active repeated ``augmented_active_count`` times
  past the real items, its ligand re-rotated by at least
  ``augmented_active_min_angle`` degrees, labelled decoy; the rotation of
  an augmented item depends only on (seed, epoch, item), within a size cap
  per item (``aug_size_cap``, ``_aug_draw``);
- class-balancing sample weights; label noise ``p_noise``; entity dropout
  ``p_remove_entity`` (edges rebuilt on the entity kept); a whole-complex
  rotation ``rot``; regression targets (``multi_regression``: 3 values);
- parquet structures, or PDB/SDF/MOL2 files typed on reading
  (``preprocessing.read_structure``), by each path's own suffix;
- smina-type or atomic-number featurisation with the compact one-hot +
  entity-bit scheme; box filter; radius graph with inter/intra radii
  (``estimate_bonds`` => intra 2.0 A) and optional pruning; edges sorted by
  (sender, receiver), stably;
- an in-memory cache of boxed graphs and their features (4 GiB budget) and
  an on-disk cache (``cache_dir``, ``data/blob.py`` files). Augmented items
  bypass both;
- ``bp``: keep one entity's atoms only (0 the ligand, 1 the receptor)
  before the edges are built, as the siamese towers' datasets do;
- ``include_strain_info``: each item carries its types line's dE and
  strain RMSD (zeros where the line has none); not with augmented actives.

``SynthPharmDataset`` is the synthetic-pharmacophore dataset
(``--synthpharm``): 12-class one-hot ``atom_id`` features, 3-class one-hot
edge attributes, no box and no rotation; ``no_receptor`` and ``bp`` keep
one entity (by the files' own ``bp``) before the edges are built. Its
``feature_dim`` is the parent's (12 with ``compact``, 22 without), as in
the reference, whatever its features' width.

The dataset's own ``RandomState(seed)`` is drawn in the reference's order
inside ``__getitem__``: the label-noise draw (every classification item),
then entity dropout (two draws, when enabled), then the rotation (three).
"""
from __future__ import annotations

import hashlib
import math
import os
from collections import defaultdict
from pathlib import Path
from typing import Optional

import numpy as np

from pointvs_tpu_torch.data.blob import load_blob, save_blob
from pointvs_tpu_torch.data.buckets import GraphSample
from pointvs_tpu_torch.data.preprocessing import (
    KEYS,
    concat_structs,
    concat_synthpharm,
    coords_of,
    generate_edges,
    make_bit_vector,
    make_box,
    read_structure,
    read_synthpharm,
    rotate_struct,
    subset,
    uniform_random_rotation,
)
from pointvs_tpu_torch.data.types_files import (
    parse_classification_types,
    parse_regression_types,
)
from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.native.build import lexsort_pairs
from pointvs_tpu_torch.utils import expand_path, shorten_home

LOG = get_logger()

_RECOGNISED_ATOMIC_NUMBERS = (6, 7, 8, 9, 15, 16, 17)
_OTHER_GROUPINGS = ((35, 53), (3, 11, 19), (4, 12, 20), (26, 29, 30))
_PROBE_EPOCH = 1 << 30   # probe keys sit far above any real epoch
_MEM_CACHE_BYTES = 4 << 30


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
                 rot: bool = False, augmented_active_count: int = 0,
                 augmented_active_min_angle: float = 90,
                 max_active_rms_distance: Optional[float] = None,
                 min_inactive_rms_distance: Optional[float] = None,
                 max_inactive_rms_distance: Optional[float] = None,
                 model_task: str = 'classification',
                 edge_radius: Optional[float] = None,
                 estimate_bonds: bool = False, prune: bool = False,
                 p_remove_entity: float = 0,
                 extended_atom_types: bool = False, p_noise: float = -1,
                 bp: Optional[int] = None,
                 include_strain_info: bool = False,
                 cache_dir=None, seed: int = 0):
        if (max_active_rms_distance is None) != (
                min_inactive_rms_distance is None):
            raise ValueError('max_active_rms_distance and '
                             'min_inactive_rms_distance go together')
        if include_strain_info and augmented_active_count:
            raise ValueError('include_strain_info cannot be combined with '
                             'augmented actives')
        self.base_path = expand_path(base_path)
        if not self.base_path.exists():
            raise FileNotFoundError(f'Dataset {self.base_path} does not '
                                    f'exist.')
        self.radius = radius
        self.polar_hydrogens = polar_hydrogens
        self.use_atomic_numbers = use_atomic_numbers
        self.compact = compact
        self.rot = rot
        self.model_task = model_task
        self.edge_radius = edge_radius if edge_radius is not None else 4.0
        self.estimate_bonds = estimate_bonds
        self.prune = prune
        self.p_remove_entity = p_remove_entity
        self.p_noise = p_noise
        self.bp = bp
        self.include_strain_info = include_strain_info
        self.dEs, self.rmsds = [], []
        self.extended_atom_types = extended_atom_types
        self.augmented_active_min_angle = augmented_active_min_angle
        self.rng = np.random.RandomState(seed)
        self.seed = seed
        self._aug_epoch = 0           # set by the train loader each epoch
        self._aug_caps: dict = {}
        self.aug_rejects = 0
        self.aug_fallbacks = 0
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._mem_cache = {}
        self._mem_cache_budget = _MEM_CACHE_BYTES
        self._seen_files: set = set()
        self._file_fps: dict = {}
        self.sample_weights = None

        if model_task.endswith('regression'):
            entries = parse_regression_types(self.base_path, types_fname)
            self.targets = list(zip(entries.pki, entries.pkd, entries.ic50))
            self.receptor_fnames = entries.receptors
            self.ligand_fnames = entries.ligands
            self.pre_aug_ds_len = len(self.ligand_fnames)
            self.labels = np.array([])
        else:
            self._init_classification(
                types_fname, max_active_rms_distance,
                min_inactive_rms_distance, max_inactive_rms_distance,
                augmented_active_count)
        LOG.info(f'There are {len(self.ligand_fnames)} data points in '
                 f'{shorten_home(base_path)}')

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
        self.feature_dim = (self.n_features + 1 if compact
                            else self.n_features * 2)

    def _init_classification(self, types_fname, max_active_rmsd,
                             min_inactive_rmsd, max_inactive_rmsd,
                             aug_count):
        label_by_rmsd = any(v is not None for v in (
            max_active_rmsd, min_inactive_rmsd, max_inactive_rmsd))
        if label_by_rmsd:
            max_active_rmsd = (np.inf if max_active_rmsd is None
                               else max_active_rmsd)
            max_inactive_rmsd = (np.inf if max_inactive_rmsd is None
                                 else max_inactive_rmsd)
            min_inactive_rmsd = (0 if min_inactive_rmsd is None
                                 else min_inactive_rmsd)
        entries = parse_classification_types(
            types_fname, include_strain_info=self.include_strain_info)
        labels, recs, ligs, aug_recs, aug_ligs = [], [], [], [], []
        for label, rmsd, rec, lig, d_e, strain_rmsd in zip(
                entries.labels, entries.rmsds, entries.receptors,
                entries.ligands, entries.dEs, entries.strain_rmsds):
            if label_by_rmsd:
                if rmsd is None or rmsd < 0:
                    continue
                if rmsd < max_active_rmsd:
                    label = 1
                elif rmsd >= max_inactive_rmsd:
                    continue
                elif rmsd >= min_inactive_rmsd:
                    label = 0
                else:
                    continue
            if label:
                aug_recs += [rec] * aug_count
                aug_ligs += [lig] * aug_count
            labels.append(label)
            recs.append(rec)
            ligs.append(lig)
            self.dEs.append(d_e)
            self.rmsds.append(strain_rmsd)
        self.pre_aug_ds_len = len(ligs)
        self.receptor_fnames = recs + aug_recs
        self.ligand_fnames = ligs + aug_ligs
        labels = labels + [0] * len(aug_ligs)
        self.labels = np.array([-1 if v is None else v for v in labels],
                               np.int64)
        # Class-balancing weights; None when single-class or unlabelled.
        if len(labels) and labels[0] is not None:
            active_count = int(np.sum(self.labels == 1))
            total = len(self.labels)
            if active_count not in (0, total):
                weights = 1.0 / np.array([total - active_count,
                                          active_count], np.float64)
                self.sample_weights = weights[np.clip(self.labels, 0, 1)]

    def __len__(self):
        return len(self.ligand_fnames)

    def set_epoch(self, epoch: int) -> None:
        """The epoch that keys the augmented items' rotations."""
        self._aug_epoch = int(epoch)

    def aug_item(self, item: int, epoch: int) -> GraphSample:
        """Augmented item ``item`` as ``__getitem__`` gives it at ``epoch``
        without the whole-complex rotation, with no draw from the shared
        random stream and no cache write (augmented items bypass the
        caches), so a background thread may featurise the next epoch's
        items while this one trains (``device_dataset.DeviceGraphStore``).
        """
        lig_path, rec_path = self._paths_for(item)
        struct, rows, cols, attrs = self._aug_draw(item, int(epoch))
        return GraphSample(
            node_feats=make_bit_vector(struct['types'], self.n_features,
                                       self.compact),
            coords=coords_of(struct).astype(np.float32), senders=rows,
            receivers=cols, edge_attr=attrs,
            y=np.float32(0),   # augmented actives are labelled decoy
            lig_fname=str(lig_path), rec_fname=str(rec_path))

    # -- augmented actives ------------------------------------------- #
    def _aug_attempt_rng(self, item: int, epoch: int,
                         attempt: int) -> np.random.RandomState:
        entropy = [int(self.seed) & 0x7fffffff, int(epoch), int(item)]
        if attempt:
            entropy.append(int(attempt))
        seed = np.random.SeedSequence(entropy).generate_state(1)[0]
        return np.random.RandomState(int(seed))

    def aug_size_cap(self, item: int):
        """(node, edge) cap on ``item``'s augmented graphs: the slack times
        the largest of the unrotated graph and the probe rotations, and at
        least the first probe's size (the fallback rotation). The probe
        count and slacks come from ``POINTVS_AUG_PROBES`` (4, at least 1:
        probe 0 is the fallback), ``POINTVS_AUG_SLACK_N`` (1.6) and
        ``POINTVS_AUG_SLACK_E`` (1.8), read on every cap as the reference
        reads them."""
        hit = self._aug_caps.get(item)
        if hit is not None:
            return hit
        lig_path, rec_path = self._paths_for(item)
        base = self._load_boxed_graph(lig_path, rec_path)
        n_max, e_max = len(base[0]['x']), len(base[1])
        fb_n = fb_e = 0
        probes = max(1, int(os.environ.get('POINTVS_AUG_PROBES', '4')))
        for j in range(probes):
            g = self._build_graph(lig_path, rec_path,
                                  self.augmented_active_min_angle,
                                  self._aug_attempt_rng(
                                      item, _PROBE_EPOCH + j, 0))
            if j == 0:
                fb_n, fb_e = len(g[0]['x']), len(g[1])
            n_max = max(n_max, len(g[0]['x']))
            e_max = max(e_max, len(g[1]))
        slack_n = float(os.environ.get('POINTVS_AUG_SLACK_N', '1.6'))
        slack_e = float(os.environ.get('POINTVS_AUG_SLACK_E', '1.8'))
        cap = (max(int(math.ceil(n_max * slack_n)), fb_n),
               max(int(math.ceil(e_max * slack_e)), fb_e))
        self._aug_caps[item] = cap
        return cap

    def _aug_draw(self, item: int, epoch: int):
        """Rotations keyed (seed, epoch, item, attempt) until one fits
        ``aug_size_cap``; after ``POINTVS_AUG_RETRIES`` (4) rejections, the
        first probe's rotation."""
        n_cap, e_cap = self.aug_size_cap(item)
        lig_path, rec_path = self._paths_for(item)
        retries = int(os.environ.get('POINTVS_AUG_RETRIES', '4'))
        for attempt in range(retries + 1):
            g = self._build_graph(
                lig_path, rec_path, self.augmented_active_min_angle,
                self._aug_attempt_rng(item, epoch, attempt))
            if len(g[0]['x']) <= n_cap and len(g[1]) <= e_cap:
                return g
            self.aug_rejects += 1
        self.aug_fallbacks += 1
        return self._build_graph(lig_path, rec_path,
                                 self.augmented_active_min_angle,
                                 self._aug_attempt_rng(item, _PROBE_EPOCH, 0))

    # -- labels, paths, graphs --------------------------------------- #
    def _label_for(self, item: int):
        if self.model_task == 'classification':
            label = int(self.labels[item]) if len(self.labels) else 0
            if self.rng.rand() < self.p_noise:
                label = 1 - label
            return np.float32(label)
        pki, pkd, ic50 = self.targets[item]
        if self.model_task == 'multi_regression':
            return np.array([pki, pkd, ic50], np.float32)
        vals = [v for v in (pki, pkd, ic50) if v is not None]
        return np.float32(max(vals) if vals else 0.0)

    def _paths_for(self, item: int):
        return (self.base_path / self.ligand_fnames[item],
                self.base_path / self.receptor_fnames[item])

    def _build_struct(self, lig_path, rec_path, aug_angle: float = 0,
                      rng=None):
        extended = self.extended_atom_types
        lig = read_structure(lig_path, 'ligand', extended)
        if aug_angle:
            lig = rotate_struct(lig, aug_angle, rng)
        rec = read_structure(rec_path, 'receptor', extended)
        struct = make_box(concat_structs(rec, lig,
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

    def _build_graph(self, lig_path, rec_path, aug_angle: float = 0,
                     rng=None):
        """(struct, rows, cols, edge_attr) of one complex (of its ``bp``
        entity alone when that is set)."""
        struct = self._build_struct(lig_path, rec_path, aug_angle, rng)
        if self.bp is not None:
            struct = subset(struct, struct['bp'] == self.bp)
        return self._edges_for(struct)

    def _edges_for(self, struct):
        edge_radius = self.edge_radius if self.edge_radius > 0 else 4
        intra_radius = 2.0 if self.estimate_bonds else edge_radius
        if self.edge_radius < 0:
            empty = np.zeros(0, np.int32)
            return struct, empty, empty, np.zeros((0, 3), np.float32)
        struct, rows, cols, attrs = generate_edges(
            struct, edge_radius, intra_radius, prune=self.prune)
        order = lexsort_pairs(rows, cols, len(struct['x']) - 1)
        rows = rows[order].astype(np.int32)
        cols = cols[order].astype(np.int32)
        onehot = np.zeros((len(order), 3), np.float32)
        onehot[np.arange(len(order)), attrs[order]] = 1.0
        return struct, rows, cols, onehot

    # -- caches ------------------------------------------------------ #
    def _file_fp(self, path) -> tuple:
        """(size, mtime_ns), once per file: a pose rewritten in place must
        not be served from the disk cache."""
        key = str(path)
        hit = self._file_fps.get(key)
        if hit is None:
            st = Path(path).stat()
            hit = self._file_fps[key] = (st.st_size, st.st_mtime_ns)
        return hit

    def _cache_key(self, lig_path, rec_path) -> Optional[Path]:
        if self.cache_dir is None:
            return None
        params = (str(lig_path), str(rec_path), self._file_fp(lig_path),
                  self._file_fp(rec_path), self.radius, self.edge_radius,
                  self.estimate_bonds, self.prune, self.polar_hydrogens,
                  self.use_atomic_numbers, self.extended_atom_types,
                  self.bp, 'torch-lex1')
        digest = hashlib.sha1(repr(params).encode()).hexdigest()[:24]
        return self.cache_dir / f'{digest}.bin'

    def _mem_cache_put(self, key, value, nbytes: int):
        if key is not None and nbytes <= self._mem_cache_budget:
            self._mem_cache[key] = value
            self._mem_cache_budget -= nbytes

    def _load_boxed_graph(self, lig_path, rec_path):
        """The unrotated graph, through the memory and disk caches."""
        mem_key = (str(lig_path), str(rec_path))
        if mem_key in self._mem_cache:
            return self._mem_cache[mem_key]
        cache_path = self._cache_key(lig_path, rec_path)
        if cache_path is not None and cache_path.exists():
            blob = load_blob(cache_path)
            graph = ({k: blob[k] for k in KEYS}, blob['rows'], blob['cols'],
                     blob['attrs'])
        else:
            graph = self._build_graph(lig_path, rec_path)
            if cache_path is not None:
                tmp = cache_path.with_suffix('.tmp.bin')
                save_blob(tmp, {'rows': graph[1], 'cols': graph[2],
                                'attrs': graph[3],
                                **{k: graph[0][k] for k in KEYS}})
                tmp.rename(cache_path)
        self._mem_cache_put(mem_key, graph,
                            sum(v.nbytes for v in graph[0].values())
                            + sum(a.nbytes for a in graph[1:]))
        return graph

    def __getitem__(self, item: int) -> GraphSample:
        label = self._label_for(item)
        lig_path, rec_path = self._paths_for(item)
        for path in (lig_path, rec_path):
            if str(path) not in self._seen_files:
                if not path.is_file():
                    raise FileNotFoundError(f'{path} does not exist.')
                self._seen_files.add(str(path))
        is_augmented = (not self.model_task.endswith('regression')
                        and item >= self.pre_aug_ds_len)
        if is_augmented:
            struct, rows, cols, attrs = self._aug_draw(item,
                                                       self._aug_epoch)
        else:
            struct, rows, cols, attrs = self._load_boxed_graph(lig_path,
                                                               rec_path)
        # Entity dropout: keep the ligand or the receptor, rebuild its
        # edges, label 0.
        dropped = (self.p_remove_entity > 0
                   and self.rng.rand() < self.p_remove_entity)
        if dropped:
            keep_bp = 0 if self.rng.rand() < 0.5 else 1
            struct, rows, cols, attrs = self._edges_for(
                subset(struct, struct['bp'] == keep_bp))
            label = (np.float32(0) if np.ndim(label) == 0
                     else np.zeros(3, np.float32))
        feat_key = (None if is_augmented or dropped
                    else (str(lig_path), str(rec_path), 'feats'))
        cached = self._mem_cache.get(feat_key)
        if cached is not None:
            coords, feats = cached
        else:
            coords = coords_of(struct).astype(np.float32)
            feats = make_bit_vector(struct['types'], self.n_features,
                                    self.compact)
            self._mem_cache_put(feat_key, (coords, feats),
                                coords.nbytes + feats.nbytes)
        if self.rot:
            coords = uniform_random_rotation(coords, self.rng).astype(
                np.float32)
        d_e = strain_rmsd = 0.0
        if self.include_strain_info and item < len(self.dEs):
            d_e = self.dEs[item] or 0.0
            strain_rmsd = self.rmsds[item] or 0.0
        return GraphSample(node_feats=feats, coords=coords, senders=rows,
                           receivers=cols, edge_attr=attrs, y=label,
                           lig_fname=str(lig_path), rec_fname=str(rec_path),
                           dE=float(d_e), rmsd=float(strain_rmsd))


class SynthPharmDataset(PointCloudDataset):
    """Synthetic pharmacophores (the reference's ``SynthPharmDataset``):
    each item is the whole complex (no box), its edges unsorted as built
    (the collator sorts them), its labels and weights the parent's."""

    SYNTH_PHARM_CLASSES = 12

    def __init__(self, *args, no_receptor: bool = False, **kwargs):
        self.no_receptor = no_receptor
        super().__init__(*args, **kwargs)

    def __getitem__(self, item: int) -> GraphSample:
        label = self._label_for(item)
        lig_path, rec_path = self._paths_for(item)
        struct = concat_synthpharm(read_synthpharm(rec_path),
                                   read_synthpharm(lig_path))
        if self.no_receptor:
            struct = subset(struct, struct['bp'] == 0)
        if self.bp is not None:
            struct = subset(struct, struct['bp'] == self.bp)
        edge_radius = self.edge_radius if self.edge_radius > 0 else 4
        intra_radius = 2.0 if self.estimate_bonds else edge_radius
        struct, rows, cols, attrs = generate_edges(
            struct, edge_radius, intra_radius, prune=self.prune,
            synthpharm=True)
        onehot_edges = np.zeros((len(attrs), 3), np.float32)
        onehot_edges[np.arange(len(attrs)), attrs] = 1.0
        atom_ids = struct['atom_id']
        feats = np.zeros((len(atom_ids), self.SYNTH_PHARM_CLASSES),
                         np.float32)
        feats[np.arange(len(atom_ids)), atom_ids] = 1.0
        return GraphSample(
            node_feats=feats, coords=coords_of(struct).astype(np.float32),
            senders=rows.astype(np.int32), receivers=cols.astype(np.int32),
            edge_attr=onehot_edges, y=label, lig_fname=str(lig_path),
            rec_fname=str(rec_path))
