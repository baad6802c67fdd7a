"""Synthetic affinity labels: an E(3)-invariant, type-weighted contact
score mapped to a pK-like range (the port's own copy of
``pointvs_tpu/dataset_generation/synthetic_affinity.py``).

For a (receptor, ligand) pose

    S  = sum over (i in lig, j in rec, d_ij < cutoff) of
             w(t_i) * w(t_j) * exp(-(d_ij / sigma)^2)
    pK = pk_max * S / (S + s0)

with per-smina-type weights w(t) = 1 + (t mod 7) / 10. The label depends
on the geometry and type channels the network sees, moves smoothly under
``replicate_poses``' perturbations and is exactly invariant to rigid
motions, so a model that learns it has learned a structure -> scalar map.
``s0`` defaults to the median S over the set, so labels made in one call
share one map (split the written types file afterwards).

Usage:
    python -m pointvs_tpu_torch.dataset_generation.synthetic_affinity \\
        <data_root> <in.types> <out.types> [--sigma 2.5] [--cutoff 8.0] \\
        [--pk_max 12] [--s0 S0]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import pandas as pd

from pointvs_tpu_torch.logging import get_logger

LOG = get_logger()


def type_weights(types: np.ndarray) -> np.ndarray:
    """Per-atom weights from the smina type channel: 1 + (t % 7) / 10."""
    return 1.0 + (np.asarray(types, dtype=np.int64) % 7) / 10.0


def contact_score(rec_df: pd.DataFrame, lig_df: pd.DataFrame,
                  sigma: float = 2.5, cutoff: float = 8.0) -> float:
    """Type-weighted soft contact count between ligand and receptor."""
    rx = rec_df[['x', 'y', 'z']].to_numpy(np.float64)
    lx = lig_df[['x', 'y', 'z']].to_numpy(np.float64)
    rw = type_weights(rec_df['types'].to_numpy())
    lw = type_weights(lig_df['types'].to_numpy())
    # Receptor atoms outside the ligand's box grown by the cutoff cannot
    # contribute; dropping them first keeps the pair matrix pocket-sized.
    lo, hi = lx.min(axis=0) - cutoff, lx.max(axis=0) + cutoff
    keep = np.all((rx >= lo) & (rx <= hi), axis=1)
    rx, rw = rx[keep], rw[keep]
    if not len(rx):
        return 0.0
    d2 = ((lx[:, None, :] - rx[None, :, :]) ** 2).sum(axis=2)
    mask = d2 < cutoff * cutoff
    if not mask.any():
        return 0.0
    w = lw[:, None] * rw[None, :]
    return float((w * np.exp(-d2 / (sigma * sigma)) * mask).sum())


def scores_to_pk(scores: np.ndarray, s0: float,
                 pk_max: float = 12.0) -> np.ndarray:
    """Raw contact scores -> a saturating pK-like range [0, pk_max)."""
    s = np.asarray(scores, dtype=np.float64)
    return pk_max * s / (s + s0)


def make_types(data_root, in_types, out_types, sigma: float = 2.5,
               cutoff: float = 8.0, pk_max: float = 12.0,
               s0: float | None = None) -> Path:
    """Write a regression types file (``-1 pK -1 rec lig``) whose pKd
    column is the synthetic label of each pose of ``in_types`` (its last
    two columns are the receptor and ligand paths)."""
    data_root, out_types = Path(data_root), Path(out_types)
    pairs = []
    for line in Path(in_types).read_text().splitlines():
        chunks = line.split()
        if len(chunks) >= 2:
            pairs.append((chunks[-2], chunks[-1]))
    receptors: dict = {}
    scores = np.empty(len(pairs))
    for i, (rec, lig) in enumerate(pairs):
        if rec not in receptors:
            receptors[rec] = pd.read_parquet(data_root / rec)
        scores[i] = contact_score(receptors[rec],
                                  pd.read_parquet(data_root / lig),
                                  sigma=sigma, cutoff=cutoff)
        if i % 200 == 0:
            LOG.info(f'{i}/{len(pairs)} poses scored')
    if s0 is None:
        s0 = float(np.median(scores))
    pks = scores_to_pk(scores, s0, pk_max)
    lines = [f'-1 {pk:.4f} -1 {rec} {lig}'
             for pk, (rec, lig) in zip(pks, pairs)]
    out_types.write_text('\n'.join(lines) + '\n')
    LOG.info(f'{len(lines)} synthetic-affinity poses -> {out_types} '
             f'(s0={s0:.3f}, pK mean {pks.mean():.2f} '
             f'std {pks.std():.2f} range [{pks.min():.2f}, '
             f'{pks.max():.2f}])')
    return out_types


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Label poses with a synthetic contact-score pK.')
    ap.add_argument('data_root')
    ap.add_argument('in_types')
    ap.add_argument('out_types')
    ap.add_argument('--sigma', type=float, default=2.5)
    ap.add_argument('--cutoff', type=float, default=8.0)
    ap.add_argument('--pk_max', type=float, default=12.0)
    ap.add_argument('--s0', type=float, default=None)
    args = ap.parse_args(argv)
    make_types(args.data_root, args.in_types, args.out_types,
               sigma=args.sigma, cutoff=args.cutoff, pk_max=args.pk_max,
               s0=args.s0)


if __name__ == '__main__':
    main()
