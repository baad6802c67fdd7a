"""Pose-selection statistics from predictions files or docking SDF trees
(counterpart of ``pointvs_tpu/analysis/pose_selection.py``; no model
runs here).

A predictions file (``<y_true> | <y_pred> <rec> <lig>`` rows, as the
serving CLI writes them) or a tree of smina ``docked_poses.sdf`` files
(ranked by their ``minimizedAffinity``) is joined with a yaml map
``{pdbid: {docked_wrt_crystal: {pose index: RMSD}}}``: the pdbid is the
receptor file's name up to its first dot, the pose index the number
after the ligand name's last underscore. ``Ranking.get_top_n`` is then
the fraction of targets with a pose within the RMSD threshold among
their ``n`` best-scored.

Usage:
    python -m pointvs_tpu_torch.analysis.pose_selection <rmsd.yaml> \\
        <predictions or sdf root> [...] [-t 2.0] [-n 10] [-g] \\
        [--output topn.png]
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np
import pandas as pd

from pointvs_tpu_torch.analysis.ranking import Ranking
from pointvs_tpu_torch.utils import get_logger, load_yaml

LOG = get_logger()


def extract_energies(sdf) -> dict:
    """``{pose index: minimizedAffinity}`` of a smina output sdf."""
    energies = {}
    record_next = False
    with open(Path(sdf).expanduser(), 'r', encoding='utf-8') as f:
        for line in f:
            if line.startswith('> <minimizedAffinity>'):
                record_next = True
                continue
            if record_next:
                energies[len(energies)] = float(line.strip())
                record_next = False
    return energies


def parse_results(predictions_fname_or_sdf_root, rmsd_info=None,
                  rmsd_info_fname=None) -> Ranking:
    """A ``Ranking`` of a predictions file (rows ``(y_true, y_pred,
    rmsd)`` by predicted score, best first; ligands named ``minimised*``
    left out) or of the ``docked_poses.sdf`` files under a directory
    (rows ``(rmsd < 2, energy, rmsd)`` by energy, lowest first)."""
    assert not (rmsd_info is None and rmsd_info_fname is None)
    if rmsd_info_fname is not None:
        rmsd_info = load_yaml(rmsd_info_fname)

    root = Path(predictions_fname_or_sdf_root).expanduser()
    sorted_lists = []
    if root.is_file():
        df = pd.read_csv(root, sep=' ',
                         names=['y_true', '|', 'y_pred', 'rec', 'lig'])
        by_rec = defaultdict(list)
        for y_true, y_pred, rec, lig in zip(df.y_true, df.y_pred, df.rec,
                                            df.lig):
            lig_stem = Path(lig).name.split('.')[0]
            if lig_stem.startswith('minimised'):
                continue
            pdbid = Path(rec).name.split('.')[0]
            rmsd = rmsd_info[pdbid]['docked_wrt_crystal'][
                int(lig_stem.split('_')[-1])]
            by_rec[rec].append((y_true, y_pred, rmsd))
        for lst in by_rec.values():
            sorted_lists.append(np.array(
                sorted(lst, key=lambda x: x[1], reverse=True)))
    elif root.is_dir():
        for docked_sdf in root.glob('**/docked_poses.sdf'):
            try:
                rmsds = rmsd_info[
                    docked_sdf.parent.name]['docked_wrt_crystal']
            except KeyError:
                continue
            energies = extract_energies(docked_sdf)
            combined = np.array(sorted(
                [(0, energies[k], rmsds[k]) for k in energies],
                key=lambda x: x[1]))
            combined[:, 0] = combined[:, 2] < 2
            sorted_lists.append(combined)
    else:
        raise FileNotFoundError(f'{root} does not exist.')
    return Ranking(root, sorted_lists)


def plot_top_n(label_to_ranking, max_n: int = 10,
               threshold_rmsd: float = 2.0):
    """TopN curves (n = 1..max_n) of each ranking (needs matplotlib)."""
    from matplotlib import pyplot as plt
    fig, ax = plt.subplots(figsize=(12, 8))
    x_rng = range(1, max_n + 1)
    for label, ranking in label_to_ranking.items():
        ax.plot(x_rng, [ranking.get_top_n(n, threshold_rmsd)
                        for n in x_rng], '-x', label=label)
    ax.set_xlabel('N')
    ax.set_ylabel('TopN')
    ax.set_title(f'Fraction of top-ranked poses within {threshold_rmsd} A '
                 f'of relaxed xtal pose')
    ax.set_ylim([0, 1])
    ax.set_xlim([1, max_n])
    ax.grid()
    ax.legend()
    return fig, ax


def prune_preds(fnames):
    """The newest predictions file of each run directory among
    ``fnames``: ``predictions.txt`` where present, else the highest
    ``predictions*_<epoch>.txt``."""
    result = []
    for run_root in {Path(f).parent for f in fnames}:
        best, best_epoch = None, -1
        for pred in run_root.glob('**/predictions*.txt'):
            if pred.name == 'predictions.txt':
                best = pred
                break
            try:
                epoch = int(pred.stem.split('_')[-1])
            except ValueError:
                continue
            if epoch > best_epoch:
                best_epoch, best = epoch, pred
        if best is not None:
            result.append(best)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument('rmsd_info', help='Yaml of pdbid -> index -> RMSD')
    ap.add_argument('results', nargs='+')
    ap.add_argument('--threshold_rmsd', '-t', type=float, default=2.0)
    ap.add_argument('--n', '-n', type=int, default=10)
    ap.add_argument('--glob', '-g', action='store_true')
    ap.add_argument('--output', default='topn.png')
    args = ap.parse_args(argv)

    rmsd_info = load_yaml(args.rmsd_info)
    fnames = []
    if args.glob:
        for fname in args.results:
            path = Path(fname)
            if not path.is_dir():
                if path.name.startswith('predictions'):
                    fnames.append(fname)
                continue
            preds = prune_preds(
                path.expanduser().glob('**/predictions*.txt'))
            fnames += preds if preds else [fname]
    else:
        fnames = args.results

    label_to_ranking = {}
    for fname in fnames:
        ranking = parse_results(fname, rmsd_info=rmsd_info)
        if len(ranking.sorted_scores_and_rmsds):
            label_to_ranking[Path(fname).parent.name] = ranking
            LOG.info(f'{fname}:\n{ranking}')
    fig, _ = plot_top_n(label_to_ranking, args.n, args.threshold_rmsd)
    fig.savefig(args.output)
    return label_to_ranking


if __name__ == '__main__':
    main()
