"""Replicate a pose set with seeded rigid perturbations (the port's own
copy of ``pointvs_tpu/dataset_generation/replicate_poses.py``).

Each written pose is a source ligand parquet rotated uniformly about its
centroid and shifted by at most ``max_shift`` (0.5 A by default), so it
stays in the pocket and keeps its label. A training set keeps the source
receptors behind a symlink; a screen library is round-robin copies of
one receptor's ligands. The same ``--seed`` writes the same files.

Usage:
    python -m pointvs_tpu_torch.dataset_generation.replicate_poses train \\
        <src_root> <src.types> <out_root> --copies 19 [--seed 0]
    python -m pointvs_tpu_torch.dataset_generation.replicate_poses screen \\
        <src_root> <receptor_id> <out_dir> --n_poses 100000 [--seed 0]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import pandas as pd

from pointvs_tpu_torch.data.preprocessing import random_rotation_matrix
from pointvs_tpu_torch.logging import get_logger

LOG = get_logger()


def _perturb(df: pd.DataFrame, rng, max_shift: float = 0.5) -> pd.DataFrame:
    """A rotation about the ligand centroid and a bounded shift; draws
    the rotation (3 numbers), a direction (3) and a length (1)."""
    xyz = df[['x', 'y', 'z']].to_numpy(np.float64)
    centre = xyz.mean(axis=0)
    m = random_rotation_matrix(rng)
    shift = rng.normal(size=3)
    shift = shift / max(np.linalg.norm(shift), 1e-9) * rng.uniform(
        0, max_shift)
    out = df.copy()
    out[['x', 'y', 'z']] = (xyz - centre) @ m + centre + shift
    return out


def make_train_set(src_root, src_types, out_root, copies: int = 19,
                   seed: int = 0, max_shift: float = 0.5) -> Path:
    """``copies`` perturbed copies of every entry of ``src_types``:
    ``<out_root>/ligands/<stem>_r<line>_<copy>.parquet``, the receptors as
    a symlink ``<out_root>/receptors`` to ``<src_root>/receptors``, and
    ``<out_root>/scale.types`` with each line's leading columns."""
    src_root, out_root = Path(src_root), Path(out_root)
    (out_root / 'ligands').mkdir(parents=True, exist_ok=True)
    rec_link = out_root / 'receptors'
    if not rec_link.exists():
        rec_link.symlink_to(src_root / 'receptors')
    rng = np.random.RandomState(seed)
    lines_out = []
    frames = {}
    src_lines = Path(src_types).read_text().splitlines()
    for li, line in enumerate(src_lines):
        parts = line.split()
        if len(parts) < 5:
            continue
        head, rec, lig = parts[:-2], parts[-2], parts[-1]
        if lig not in frames:
            frames[lig] = pd.read_parquet(src_root / lig)
        stem = Path(lig).stem
        for c in range(copies):
            rel = f'ligands/{stem}_r{li}_{c}.parquet'
            _perturb(frames[lig], rng, max_shift).to_parquet(out_root / rel)
            lines_out.append(' '.join(head + [rec, rel]))
        if li % 100 == 0:
            LOG.info(f'{li}/{len(src_lines)} seed poses replicated')
    types_out = out_root / 'scale.types'
    types_out.write_text('\n'.join(lines_out) + '\n')
    LOG.info(f'{len(lines_out)} training poses -> {types_out}')
    return types_out


def make_screen_library(src_root, receptor_id, out_dir,
                        n_poses: int = 100000, seed: int = 0,
                        max_shift: float = 0.5) -> Path:
    """Perturbed copies of the ligands under
    ``<src_root>/ligands/<receptor_id>_*/``, in turns, until ``n_poses``
    files ``<stem>_p<round>.parquet`` are in ``out_dir``."""
    src_root, out_dir = Path(src_root), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    seeds = sorted((src_root / 'ligands').glob(f'{receptor_id}_*/*.parquet'))
    if not seeds:
        raise SystemExit(f'no ligands for receptor {receptor_id}')
    frames = [pd.read_parquet(p) for p in seeds]
    rng = np.random.RandomState(seed)
    n_written = 0
    c = 0
    while n_written < n_poses:
        for p, df in zip(seeds, frames):
            if n_written >= n_poses:
                break
            _perturb(df, rng, max_shift).to_parquet(
                out_dir / f'{p.stem}_p{c}.parquet')
            n_written += 1
            if n_written % 10000 == 0:
                LOG.info(f'{n_written}/{n_poses} screen poses written')
        c += 1
    LOG.info(f'{n_written} screen poses in {out_dir}')
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Replicate poses with seeded rigid perturbations.')
    sub = ap.add_subparsers(dest='cmd', required=True)
    t = sub.add_parser('train')
    t.add_argument('src_root')
    t.add_argument('src_types')
    t.add_argument('out_root')
    t.add_argument('--copies', type=int, default=19)
    t.add_argument('--seed', type=int, default=0)
    t.add_argument('--max_shift', type=float, default=0.5)
    s = sub.add_parser('screen')
    s.add_argument('src_root')
    s.add_argument('receptor_id')
    s.add_argument('out_dir')
    s.add_argument('--n_poses', type=int, default=100000)
    s.add_argument('--seed', type=int, default=0)
    s.add_argument('--max_shift', type=float, default=0.5)
    args = ap.parse_args(argv)
    if args.cmd == 'train':
        make_train_set(args.src_root, args.src_types, args.out_root,
                       copies=args.copies, seed=args.seed,
                       max_shift=args.max_shift)
    else:
        make_screen_library(args.src_root, args.receptor_id, args.out_dir,
                            n_poses=args.n_poses, seed=args.seed,
                            max_shift=args.max_shift)


if __name__ == '__main__':
    main()
