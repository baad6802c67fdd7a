"""The benchmark's inputs, made from the run's seed: the pose set, its
labels and manifest, and the model's weights.

Poses are rigid perturbations of the test ligand
(``tests/resources/lig_0.parquet``) in its pocket of
``tests/resources/rec_0.parquet``: a rotation about the ligand's centroid
by an angle up to ``max_angle_deg`` about a uniform axis, and a Gaussian
shift of ``shift_sd`` A per axis, for the near-native share of the set
and for the rest. The shifts move atoms in and out of the 10 A pocket, so
each pose has its own box and edges. The perturbations come from the
traffic's ``pose_pool_seed``, so that every run serves the same set of
graph sizes; the run's seed orders them, which decides the file names, the
library's order and the batches. The pool is written once per checkout,
under ``.cache/poses/`` beside this file; a run copies its files from
there, under its own names in its seed's order. Labels follow each pose's RMSD from the
crystal pose: 1 below ``active_rmsd``; a pK of ``pk_native`` less
``pk_per_rmsd`` per A of RMSD, with Gaussian noise of ``pk_sd`` from the
run's seed.

Weights follow ``reference/egnn.param_schema``: one uniform draw on the
device from a ``torch.Generator`` seeded by the run's seed, split and
scaled leaf by leaf.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
POOLS = Path(__file__).resolve().parent / '.cache' / 'poses'
# The traffic's keys that decide the pool's poses, and the pool's layout.
POOL_KEYS = ('poses', 'pose_pool_seed', 'near_share', 'near', 'far')
POOL_FORMAT = 1
RESOURCES = REPO / 'tests' / 'resources'
RECEPTOR = 'rec_0.parquet'
# The run's seed feeds several streams; each takes its own salt.
SALT = {'order': 1, 'pk': 2, 'sample': 3}


def seeded(seed: int, salt: str) -> np.random.Generator:
    return np.random.default_rng([SALT[salt], int(seed)])


def _rotation(rng: np.random.Generator, max_deg: float) -> np.ndarray:
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.uniform(0, max_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def perturbations(traffic: dict, n: int) -> tuple:
    """(coordinates [n, atoms, 3], RMSD [n]) of the pose pool."""
    import pyarrow.parquet as pq
    lig = pq.read_table(RESOURCES / 'lig_0.parquet')
    xyz = np.stack([lig.column(c).to_numpy() for c in 'xyz'], 1)
    centre = xyz.mean(0)
    rng = np.random.default_rng(traffic['pose_pool_seed'])
    coords, rmsd = [], []
    for _ in range(n):
        kind = (traffic['near'] if rng.random() < traffic['near_share']
                else traffic['far'])
        rot = _rotation(rng, kind['max_angle_deg'])
        new = ((xyz - centre) @ rot.T + centre
               + rng.standard_normal(3) * kind['shift_sd'])
        coords.append(new)
        rmsd.append(float(np.sqrt(((new - xyz) ** 2).sum(1).mean())))
    return np.stack(coords), np.array(rmsd)


def pose_pool(traffic: dict) -> tuple:
    """([n] the bytes of each pose's ligand file, [n] RMSD) of the
    traffic's pose pool, written on first use into one file in a
    directory named by a digest of ``POOL_KEYS`` and ``POOL_FORMAT``
    (staged under a temporary name, then renamed into place)."""
    import pyarrow.parquet as pq
    key = json.dumps([POOL_FORMAT, {k: traffic[k] for k in POOL_KEYS}],
                     sort_keys=True)
    pool = POOLS / hashlib.sha256(key.encode()).hexdigest()[:16]
    if not (pool / 'rmsd.npy').exists():
        POOLS.mkdir(parents=True, exist_ok=True)
        stage = Path(tempfile.mkdtemp(prefix='.stage-', dir=POOLS))
        coords, rmsd = perturbations(traffic, traffic['poses'])
        lig = pq.read_table(RESOURCES / 'lig_0.parquet')
        sizes = []
        with open(stage / 'poses.bin', 'wb') as out:
            for xyz in coords:
                table = lig
                for j, col in enumerate('xyz'):
                    table = table.set_column(
                        table.schema.get_field_index(col), col, [xyz[:, j]])
                at = out.tell()
                pq.write_table(table, out)
                sizes.append(out.tell() - at)
        np.save(stage / 'sizes.npy', np.array(sizes, np.int64))
        np.save(stage / 'rmsd.npy', rmsd)
        try:
            os.rename(stage, pool)
        except OSError:   # another run wrote the same pool first
            shutil.rmtree(stage, ignore_errors=True)
    blob = (pool / 'poses.bin').read_bytes()
    ends = np.cumsum(np.load(pool / 'sizes.npy'))
    return ([blob[e - s:e] for s, e in zip(np.load(pool / 'sizes.npy'), ends)],
            np.load(pool / 'rmsd.npy'))


def write_pose_set(traffic: dict, seed: int, root: Path) -> dict:
    """Write the receptor, the ligand files (the pool's, in the seed's
    order) and the manifests under ``root``. -> dict with, in manifest
    order, the ligand paths, labels, pK values and RMSDs, and the paths of
    the two manifests ('classification' and 'regression' types files over
    the same poses)."""
    n = traffic['poses']
    pool, rmsd = pose_pool(traffic)
    order = seeded(seed, 'order').permutation(n)
    rmsd = rmsd[order]
    root.mkdir(parents=True, exist_ok=True)
    (root / RECEPTOR).write_bytes((RESOURCES / RECEPTOR).read_bytes())
    files = [root / f'lig_{i:05d}.parquet' for i in range(n)]
    for path, i in zip(files, order):
        path.write_bytes(pool[i])
    labels = (rmsd < traffic['active_rmsd']).astype(np.int64)
    pk = [f'{v:.4f}' for v in (
        traffic['pk_native'] - traffic['pk_per_rmsd'] * rmsd
        + seeded(seed, 'pk').standard_normal(n) * traffic['pk_sd'])]
    manifests = {'classification': root / 'poses.types',
                 'regression': root / 'affinity.types'}
    manifests['classification'].write_text(''.join(
        f'{labels[i]} {rmsd[i]:.4f} {RECEPTOR} {files[i].name}\n'
        for i in range(n)))
    manifests['regression'].write_text(''.join(
        f'{pk[i]} -1 -1 {RECEPTOR} {files[i].name}\n'
        for i in range(n)))
    return dict(root=root, files=files, labels=labels,
                pk=np.array([float(v) for v in pk], np.float32), rmsd=rmsd,
                manifests=manifests)


def cli_flags(flags: dict) -> list:
    """A configuration's flags as the training CLI's arguments."""
    argv = []
    for flag, value in flags.items():
        if value is True:
            argv.append(f'--{flag}')
        elif value is not False:
            argv += [f'--{flag}', str(value)]
    return argv


def make_weights(schema: list, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} for ``schema``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(int(np.prod(shape)) for _, shape, init in schema
                if init[0] == 'uniform')
    draw = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape, (kind, value) in schema:
        if kind == 'const':
            out[name] = torch.full(shape, value, device=device)
            continue
        size = int(np.prod(shape))
        out[name] = (draw[at:at + size] * value).reshape(shape)
        at += size
    return out
