"""Bond attributions against MD bond lengths, as a Spearman plot
(counterpart of ``pointvs_tpu/attribution/md_gnn_correlation.py``; a
plotting front end over ``gromacs``' parsers, no model run).

Usage:
    python -m pointvs_tpu_torch.attribution.md_gnn_correlation \\
        <hbnum.xvg> <bond_scores.csv> [-o md_gnn_out]
"""
from __future__ import annotations

import argparse

import pandas as pd

from pointvs_tpu_torch.attribution.gromacs import (
    bond_distance_stats,
    correlate_md_with_attribution,
    parse_xvg,
)
from pointvs_tpu_torch.utils import get_logger, mkdir

LOG = get_logger()


def plot_correlation(bond_stats: pd.DataFrame, bond_scores: pd.DataFrame,
                     fname):
    """A scatter of each bond's score against its mean MD length, titled
    with Spearman's rho, saved to ``fname`` (needs matplotlib)."""
    from matplotlib import pyplot as plt
    from scipy.stats import spearmanr
    merged = bond_stats.merge(bond_scores, on='bond')
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.scatter(merged['mean'], merged['score'])
    rho, p = spearmanr(merged['mean'], merged['score']) if len(merged) > 2 \
        else (float('nan'), 1.0)
    ax.set_xlabel('Mean MD bond length (nm)')
    ax.set_ylabel('GNN bond attribution')
    ax.set_title(f'Spearman rho = {rho:.3f} (p = {p:.3g})')
    fig.savefig(fname)
    return fig, ax


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('hbnum_xvg')
    ap.add_argument('bond_scores_csv')
    ap.add_argument('--output_dir', '-o', default='md_gnn_out')
    args = ap.parse_args(argv)
    out = mkdir(args.output_dir)
    stats = bond_distance_stats(parse_xvg(args.hbnum_xvg))
    scores = pd.read_csv(args.bond_scores_csv)
    rho, p = correlate_md_with_attribution(stats, scores)
    LOG.info(f'Spearman rho={rho:.4f} (p={p:.4g})')
    plot_correlation(stats, scores, out / 'md_gnn_correlation.png')
    return rho, p


if __name__ == '__main__':
    main()
