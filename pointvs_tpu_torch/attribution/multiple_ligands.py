"""Attributions aggregated over many ligands of one receptor (counterpart
of ``pointvs_tpu/attribution/multiple_ligands.py``).

``rank_protein_atoms`` scores every (receptor, ligand) pair, maps each
pair's receptor-atom scores onto the receptor by coordinates and ranks
the receptor atoms by their mean attribution over the ligands (consensus
hotspots); ``bond_rank_correlation`` is the mean Spearman correlation of
the bond-masking scores between pairs of ligands.

Usage:
    python -m pointvs_tpu_torch.attribution.multiple_ligands <run_dir> \
        <receptor> <ligand> [<ligand> ...] [--attribution atom_masking] \
        [-o multiple_ligands_out] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from collections import defaultdict
import numpy as np
import pandas as pd

from pointvs_tpu_torch.attribution.attribution import score_atoms
from pointvs_tpu_torch.attribution.attribution_fns import ATTRIBUTION_FNS
from pointvs_tpu_torch.device import resolve_device
from pointvs_tpu_torch.models.load_model import load_model
from pointvs_tpu_torch.utils import coords_to_string, get_logger, mkdir

LOG = get_logger()


def rank_protein_atoms(trainer, rec, lig_files, attribution_fn,
                       radius: float = 12, edge_radius: float = 4
                       ) -> pd.DataFrame:
    """Mean per-receptor-atom attribution over all ligands."""
    sums = defaultdict(float)
    counts = defaultdict(int)
    coords_of = {}
    for lig in lig_files:
        scored = score_atoms(trainer, rec, lig, attribution_fn,
                             radius=radius, edge_radius=edge_radius)
        rec_rows = scored[scored.bp == 1]
        for _, row in rec_rows.iterrows():
            key = coords_to_string((row.x, row.y, row.z))
            sums[key] += float(row.attribution)
            counts[key] += 1
            coords_of[key] = (row.x, row.y, row.z)
    rows = [{'x': coords_of[k][0], 'y': coords_of[k][1],
             'z': coords_of[k][2], 'mean_attribution': sums[k] / counts[k],
             'n_complexes': counts[k]} for k in sums]
    df = pd.DataFrame(rows).sort_values(
        'mean_attribution', ascending=False).reset_index(drop=True)
    df['rank'] = np.arange(1, len(df) + 1)
    return df


def bond_rank_correlation(trainer, rec, lig_files,
                          radius: float = 12, edge_radius: float = 4):
    """Spearman correlation between per-complex bond attribution ranks
    (consistency of the explanation across ligands)."""
    from scipy.stats import spearmanr
    per_lig = []
    for lig in lig_files:
        scored = score_atoms(trainer, rec, lig,
                             ATTRIBUTION_FNS['bond_masking'],
                             radius=radius, edge_radius=edge_radius)
        per_lig.append(scored)
    correlations = []
    for i in range(len(per_lig)):
        for j in range(i + 1, len(per_lig)):
            merged = per_lig[i].merge(
                per_lig[j], on=['x', 'y', 'z'], suffixes=('_a', '_b'))
            if len(merged) > 2:
                rho, _ = spearmanr(merged.attribution_a,
                                   merged.attribution_b)
                correlations.append(rho)
    return float(np.mean(correlations)) if correlations else float('nan')


def main(argv=None) -> pd.DataFrame:
    ap = argparse.ArgumentParser()
    ap.add_argument('model')
    ap.add_argument('receptor')
    ap.add_argument('ligands', nargs='+')
    ap.add_argument('--attribution', default='atom_masking')
    ap.add_argument('--output_dir', '-o', default='multiple_ligands_out')
    ap.add_argument('--radius', type=float, default=12)
    ap.add_argument('--edge_radius', type=float, default=4)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)

    out = mkdir(args.output_dir)
    trainer, _, _ = load_model(args.model, resolve_device(args.device))
    df = rank_protein_atoms(
        trainer, args.receptor, args.ligands,
        ATTRIBUTION_FNS[args.attribution],
        radius=args.radius, edge_radius=args.edge_radius)
    df.to_csv(out / 'protein_atom_ranks.csv', index=False)
    LOG.info(f"Protein atom ranking written to "
             f"{out / 'protein_atom_ranks.csv'}")
    return df


if __name__ == '__main__':
    main()
