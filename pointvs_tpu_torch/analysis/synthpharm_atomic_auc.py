"""Average precision of attributions on synthetic pharmacophores
(counterpart of ``pointvs_tpu/analysis/synthpharm_atomic_auc.py``).

Each complex of a ``SynthPharmDataset`` directory is scored atom by atom
with one attribution method on the model's device; its atoms are labelled
from ``atomic_labels.yaml`` (ligand index -> coordinates, keyed as
``coords_to_string`` writes them) beside the directory, for the ligands
that ``labels.yaml`` marks. The statistics are the average precision
(``plip_subclasses.average_precision``, scikit-learn's definition) and
the rank of the first true positive, for ligand and receptor atoms apart.

Usage:
    python -m pointvs_tpu_torch.analysis.synthpharm_atomic_auc <run_dir> \\
        <directory> <types> [--attribution atom_masking] [--no_receptor] \\
        [--output_dir synthpharm_stats] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import pandas as pd

from pointvs_tpu_torch.attribution.attribution import model_batch
from pointvs_tpu_torch.attribution.attribution_fns import ATTRIBUTION_FNS
from pointvs_tpu_torch.attribution.plip_subclasses import average_precision
from pointvs_tpu_torch.data.dataset import SynthPharmDataset
from pointvs_tpu_torch.device import resolve_device
from pointvs_tpu_torch.models.load_model import load_model
from pointvs_tpu_torch.utils import PositionDict, coords_to_string, \
    expand_path, get_logger, load_yaml, mkdir

LOG = get_logger()


def label_df(df: pd.DataFrame, positions: PositionDict) -> pd.DataFrame:
    """``df`` with ``y_true``: 1 where its coordinates are in
    ``positions``."""
    coords = np.stack([df.x.to_numpy(), df.y.to_numpy(),
                       df.z.to_numpy()], axis=1)
    df = df.copy()
    df['y_true'] = [int(coords_to_string(c) in positions) for c in coords]
    return df


def get_stats_from_dir(model_fname, directory, types, attribution_fn,
                       no_receptor: bool = False, model_task=None,
                       device: str = 'cuda'):
    """(ligand random baselines, ligand APs, receptor random baselines,
    receptor APs, ligand first-hit ranks, receptor first-hit ranks) over
    the labelled complexes, the model run on ``device``."""
    trainer, _, cmd_args = load_model(model_fname, resolve_device(device))
    if model_task:
        trainer.set_task(model_task)
    directory = expand_path(directory)
    atom_labels = load_yaml(directory.parent / 'atomic_labels.yaml')
    mol_labels = load_yaml(directory.parent / 'labels.yaml')

    ds = SynthPharmDataset(
        no_receptor=no_receptor, base_path=directory,
        radius=cmd_args.get('radius', 10), polar_hydrogens=False,
        use_atomic_numbers=False, compact=True, types_fname=types,
        edge_radius=cmd_args.get('edge_radius', 4),
        estimate_bonds=cmd_args.get('estimate_bonds', False),
        prune=cmd_args.get('prune', False))

    lig_rand, lig_ap, rec_rand, rec_ap = [], [], [], []
    lig_positions, rec_positions = [], []
    for item in range(len(ds)):
        fname_idx = int(Path(ds.ligand_fnames[item]).stem.split('lig')[-1])
        if not mol_labels.get(fname_idx):
            continue
        sample = ds[item]
        model, batch = model_batch(trainer, sample)
        scores = attribution_fn(model, batch, task=trainer.model_task)
        bp = (sample.node_feats[:, :3].sum(axis=1) > 0).astype(int)
        df = pd.DataFrame({
            'x': sample.coords[:, 0], 'y': sample.coords[:, 1],
            'z': sample.coords[:, 2],
            'bp': bp, 'attribution': scores[:sample.num_nodes]})
        df = label_df(df, PositionDict({
            coords_to_string(c): True for c in atom_labels[fname_idx]}))
        df = df.sort_values(by='attribution', ascending=False)
        for part, rand, ap, positions in (
                (df[df.bp == 0], lig_rand, lig_ap, lig_positions),
                (df[df.bp == 1], rec_rand, rec_ap, rec_positions)):
            if len(part) and part.y_true.sum():
                positions += list(np.where(part.y_true > 0.5)[0])[:1]
                rand.append(part.y_true.sum() / len(part))
                ap.append(average_precision(part.y_true, part.attribution))
    return lig_rand, lig_ap, rec_rand, rec_ap, lig_positions, rec_positions


def plot_rank_histogram(lig_ranks, rec_ranks, title=None, fname=None):
    """Histograms of the first true positive's rank, ligand above
    receptor (needs matplotlib)."""
    from matplotlib import pyplot as plt
    fig, axs = plt.subplots(2, 1, sharex=True, figsize=(10, 10))
    max_rank = max(lig_ranks + rec_ranks) if (lig_ranks or rec_ranks) else 1
    for idx, (ranks, subtitle) in enumerate(
            zip([lig_ranks, rec_ranks], ['Ligand', 'Receptor'])):
        axs[idx].hist(ranks, bins=list(range(int(max_rank) + 2)))
        axs[idx].set_title(subtitle)
        axs[idx].set_xlabel('Rank of first true positive')
    if title:
        fig.suptitle(title)
    if fname:
        fig.savefig(fname)
    return fig, axs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('model')
    ap.add_argument('directory')
    ap.add_argument('types')
    ap.add_argument('--attribution', default='atom_masking')
    ap.add_argument('--no_receptor', action='store_true')
    ap.add_argument('--output_dir', default='synthpharm_stats')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)

    out = mkdir(args.output_dir)
    stats = get_stats_from_dir(
        args.model, args.directory, args.types,
        ATTRIBUTION_FNS[args.attribution], no_receptor=args.no_receptor,
        device=args.device)
    lig_rand, lig_ap, rec_rand, rec_ap, lig_pos, rec_pos = stats
    LOG.info(f'Ligand AP {np.mean(lig_ap):.4f} (random '
             f'{np.mean(lig_rand):.4f}); receptor AP {np.mean(rec_ap):.4f} '
             f'(random {np.mean(rec_rand):.4f})')
    plot_rank_histogram(lig_pos, rec_pos, fname=out / 'rank_histogram.png')
    return stats


if __name__ == '__main__':
    main()
