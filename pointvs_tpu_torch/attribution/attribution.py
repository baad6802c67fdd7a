"""Attribution driver: load a model, score one complex, attribute it,
write the scores (counterpart of ``pointvs_tpu/attribution/attribution.py``).

``score_atoms`` builds the pocket graph of one complex as the reference's
does: the structures (parquet, or PDB/SDF/MOL2 typed by
``StructuralFileParser``) concatenated ligand first, boxed within
``radius`` of the ligand, hydrogens dropped, radius edges in their built
order (the inter-molecular block, then the intra block), compact
features; then one attribution method (``attribution_fns``) on the
model's device. Edge-level methods are mapped onto their end atoms by the
built edge order while their scores come in the batch's sender-sorted
order, as in the reference (ROADMAP.md, Queue 3).

``attribute`` writes ``<method>_scores.csv`` (the boxed structure with an
``attribution`` column), ``<method>_labelled.csv`` (geometric interaction
labels, where the ligand has both labelled and unlabelled atoms) and, for
a PDB receptor, ``<method>_bfactors.pdb`` (the receptor file with the
scores as B-factors, matched by coordinates).

Usage:
    python -m pointvs_tpu_torch.attribution.attribution <method> <run_dir> \\
        <output_dir> (--pdbid XXXX | --rec r.{pdb,parquet} \\
        --lig l.{sdf,mol2,parquet}) [--radius 12] [--edge_radius 4] \\
        [--estimate_bonds] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd
import torch

from pointvs_tpu_torch.attribution.attribution_fns import ATTRIBUTION_FNS
from pointvs_tpu_torch.data.buckets import GraphSample, cast_floats, \
    to_device
from pointvs_tpu_torch.data.preprocessing import (
    KEYS,
    concat_structs,
    generate_edges,
    make_bit_vector,
    make_box,
    read_structure,
    subset,
)
from pointvs_tpu_torch.data.single_item import get_single_graph_for_inference
from pointvs_tpu_torch.dataset_generation.types_to_parquet import (
    StructuralFileParser,
)
from pointvs_tpu_torch.device import refuse_double_on_cuda, resolve_device
from pointvs_tpu_torch.models.load_model import load_model, run_args
from pointvs_tpu_torch.utils import PositionDict, coords_to_string, \
    expand_path, get_logger, mkdir

LOG = get_logger()


def download_pdb_file(pdbid: str, output_dir) -> Path:
    """Fetch a PDB from RCSB through the local cache
    (``StructuralFileParser.download_pdb_file``)."""
    return StructuralFileParser.download_pdb_file(pdbid, output_dir)


def pocket_graph(rec, lig, radius: float = 12, edge_radius: float = 4,
                 estimate_bonds: bool = False, prune: bool = False,
                 extended: bool = False):
    """(struct, rows, cols, sample): one complex boxed within ``radius``
    of its ligand, hydrogens dropped, its radius edges in their built
    order and its one-graph ``GraphSample`` (compact features)."""
    n_features = 11 + 8 * extended
    struct = make_box(concat_structs(
        read_structure(rec, 'receptor', extended),
        read_structure(lig, 'ligand', extended), n_features,
        extended=extended), radius)
    struct = subset(struct, struct['atomic_number'] > 1)
    intra_radius = 2.0 if estimate_bonds else edge_radius
    struct, rows, cols, attrs = generate_edges(
        struct, inter_radius=edge_radius, intra_radius=intra_radius,
        prune=prune)
    onehot = np.zeros((len(attrs), 3), np.float32)
    onehot[np.arange(len(attrs)), attrs] = 1.0
    coords = np.stack([struct['x'], struct['y'], struct['z']], axis=1)
    sample = GraphSample(
        node_feats=make_bit_vector(struct['types'], n_features,
                                   compact=True),
        coords=coords.astype(np.float32), senders=rows, receivers=cols,
        edge_attr=onehot, y=np.float32(0))
    return struct, rows, cols, sample


def model_batch(trainer, sample: GraphSample):
    """(model in eval mode, the sample as a one-graph batch on the
    trainer's device, in the model's float type)."""
    model = trainer.model.eval()
    batch = to_device(get_single_graph_for_inference(sample),
                      trainer.device)
    dtype = next(model.parameters()).dtype
    if dtype == torch.float64:
        batch = cast_floats(batch, dtype)
    return model, batch


def score_atoms(trainer, rec, lig, attribution_fn, radius: float = 12,
                edge_radius: float = 4, estimate_bonds: bool = False,
                prune: bool = False, extended: bool = False,
                only_process: Optional[str] = None) -> pd.DataFrame:
    """The boxed structure of one complex with per-atom scores in an
    ``attribution`` column (edge methods also leave ``edge_scores`` and
    ``edge_indices`` in the frame's ``attrs``)."""
    del only_process
    struct, rows, cols, sample = pocket_graph(
        rec, lig, radius, edge_radius, estimate_bonds, prune, extended)
    model, batch = model_batch(trainer, sample)
    scores = attribution_fn(model, batch, task=trainer.model_task)

    frame = pd.DataFrame({k: struct[k] for k in KEYS})
    if len(scores) == len(frame):
        frame['attribution'] = scores
    else:   # an edge method: each bond's score onto both its atoms
        atom_scores = np.zeros(len(frame))
        np.add.at(atom_scores, rows[:len(scores)], scores)
        np.add.at(atom_scores, cols[:len(scores)], scores)
        frame['attribution'] = atom_scores
        frame.attrs['edge_scores'] = scores
        frame.attrs['edge_indices'] = (rows, cols)
    return frame


def colour_b_factors_pdb(input_pdb, output_pdb, scored_struct: pd.DataFrame,
                         eps: float = 1e-2) -> Path:
    """A copy of ``input_pdb`` whose B-factor columns hold the scores of
    the atoms found in ``scored_struct`` by coordinates (within ``eps``)."""
    score_map = PositionDict(eps=eps)
    for x, y, z, score in zip(scored_struct.x, scored_struct.y,
                              scored_struct.z, scored_struct.attribution):
        score_map[(x, y, z)] = float(score)
    out_lines = []
    matched = 0
    with open(expand_path(input_pdb), 'r', encoding='utf-8',
              errors='replace') as f:
        for line in f:
            if line.startswith(('ATOM', 'HETATM')) and len(line) >= 66:
                try:
                    key = coords_to_string(
                        [float(line[30:38]), float(line[38:46]),
                         float(line[46:54])], eps=eps)
                    score = score_map.get(key)
                except ValueError:
                    score = None
                if score is not None:
                    line = line[:60] + f'{score:6.2f}' + line[66:]
                    matched += 1
            out_lines.append(line)
    output_pdb = expand_path(output_pdb)
    with open(output_pdb, 'w', encoding='utf-8') as f:
        f.writelines(out_lines)
    LOG.info(f'Wrote {matched} attribution B-factors to {output_pdb}')
    return output_pdb


def attribute(method: str, model_path, output_dir, rec=None, lig=None,
              pdbid: Optional[str] = None, radius: float = 12,
              edge_radius: float = 4, estimate_bonds: bool = False,
              write_pdb: bool = True, device: str = 'cuda',
              **kwargs) -> pd.DataFrame:
    """Score one complex with one method and write its artefacts; the
    scored frame."""
    del kwargs
    if method not in ATTRIBUTION_FNS:
        raise ValueError(f'method must be one of {sorted(ATTRIBUTION_FNS)}')
    output_dir = mkdir(output_dir)
    if pdbid is not None:
        rec = download_pdb_file(pdbid, output_dir / pdbid)
    if rec is None or lig is None:
        raise ValueError('Either --pdbid or both --rec and --lig required')
    refuse_double_on_cuda(run_args(model_path).get('double', False), device)
    trainer, _, cmd_args = load_model(model_path, resolve_device(device))
    scored = score_atoms(
        trainer, rec, lig, ATTRIBUTION_FNS[method], radius=radius,
        edge_radius=edge_radius, estimate_bonds=estimate_bonds,
        extended=bool(cmd_args.get('extended_atom_types', False)))

    csv_path = output_dir / f'{method}_scores.csv'
    scored.to_csv(csv_path, index=False)
    LOG.info(f'Per-atom scores written to {csv_path}')
    if (scored.bp == 0).any() and (scored.bp == 1).any():
        from pointvs_tpu_torch.attribution.plip_subclasses import \
            attribution_precision_recall
        ap, random_baseline, labelled = attribution_precision_recall(scored)
        if np.isfinite(ap):
            LOG.info(f'Attribution average precision vs interaction '
                     f'labels: {ap:.4f} (random {random_baseline:.4f})')
            labelled.to_csv(output_dir / f'{method}_labelled.csv',
                            index=False)
    if write_pdb and Path(rec).suffix == '.pdb':
        colour_b_factors_pdb(rec, output_dir / f'{method}_bfactors.pdb',
                             scored)
    return scored


def main(argv=None) -> pd.DataFrame:
    ap = argparse.ArgumentParser()
    ap.add_argument('attribution_type',
                    help=f'One of {sorted(ATTRIBUTION_FNS)}')
    ap.add_argument('model', help='Trained run directory or checkpoint')
    ap.add_argument('output_dir')
    ap.add_argument('--pdbid', help='RCSB structure to fetch and score')
    ap.add_argument('--rec', help='Receptor file (pdb or parquet)')
    ap.add_argument('--lig', help='Ligand file (sdf/mol2 or parquet)')
    ap.add_argument('--radius', type=float, default=12)
    ap.add_argument('--edge_radius', type=float, default=4)
    ap.add_argument('--estimate_bonds', action='store_true')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)
    return attribute(args.attribution_type, args.model, args.output_dir,
                     rec=args.rec, lig=args.lig, pdbid=args.pdbid,
                     radius=args.radius, edge_radius=args.edge_radius,
                     estimate_bonds=args.estimate_bonds, device=args.device)


if __name__ == '__main__':
    main()
