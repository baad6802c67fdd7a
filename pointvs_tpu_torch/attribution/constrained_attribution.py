"""Attribution of a series of ligands docked with a constrained core
against one receptor (counterpart of
``pointvs_tpu/attribution/constrained_attribution.py``).

Each ligand is scored by ``attribution.score_atoms`` on the model's
device, and each of its atoms gets its distance to the closest atom of
the conserved core. The core is the heavy atoms of an explicit
``--core_ligand`` (a structure file or a parquet) or, without one, each
ligand's own match of the series' maximum common substructure (RDKit's
FindMCS; needs RDKit and sdf/mol/mol2 ligands).

Usage:
    python -m pointvs_tpu_torch.attribution.constrained_attribution \\
        <run_dir> <receptor> <ligand> [<ligand> ...] \\
        [--core_ligand <file>] [--attribution atom_masking] \\
        [-o constrained_out] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import pandas as pd

from pointvs_tpu_torch.attribution.attribution import score_atoms
from pointvs_tpu_torch.attribution.attribution_fns import ATTRIBUTION_FNS
from pointvs_tpu_torch.dataset_generation.types_to_parquet import \
    StructuralFileParser
from pointvs_tpu_torch.device import resolve_device
from pointvs_tpu_torch.models.load_model import load_model
from pointvs_tpu_torch.utils import expand_path, get_logger, mkdir

LOG = get_logger()


def distance_to_core(scored: pd.DataFrame, core_coords: np.ndarray
                     ) -> pd.DataFrame:
    """The ligand rows of ``scored`` with ``core_distance``: each atom's
    distance to the closest of ``core_coords``."""
    lig = scored[scored.bp == 0].copy()
    xyz = np.stack([lig.x, lig.y, lig.z], axis=1)
    diff = xyz[:, None, :] - core_coords[None, :, :]
    lig['core_distance'] = np.sqrt(
        np.einsum('ijk,ijk->ij', diff, diff)).min(axis=1)
    return lig


def mcs_core_coords(lig_files) -> dict:
    """``{ligand path: [n, 3] coordinates of its atoms matching the
    series' maximum common substructure}``; a ligand with other than one
    match is left out with a warning. Needs RDKit (raises
    ``ImportError`` without it) and sdf/mol/mol2 files."""
    from rdkit import Chem
    from rdkit.Chem.rdFMCS import FindMCS

    def read(f):
        f = str(f)
        if f.endswith('.sdf'):
            return Chem.SDMolSupplier(f, True, False)[0]
        if f.endswith('.mol'):
            return Chem.MolFromMolFile(f)
        if f.endswith('.mol2'):
            return Chem.MolFromMol2File(f)
        raise ValueError(f'FindMCS core detection needs sdf/mol/mol2 '
                         f'ligands, got {f}: pass --core_ligand instead')

    mols = {str(f): read(f) for f in lig_files}
    mcs = Chem.MolFromSmarts(FindMCS(list(mols.values())).smartsString)
    cores = {}
    for path, mol in mols.items():
        matches = mol.GetSubstructMatches(mcs)
        if len(matches) != 1:
            LOG.warning(f'{len(matches)} MCS matches for {path}, not one: '
                        f'left out')
            continue
        conf = mol.GetConformer()
        cores[path] = np.array(
            [[conf.GetAtomPosition(i).x, conf.GetAtomPosition(i).y,
              conf.GetAtomPosition(i).z] for i in matches[0]])
    return cores


def core_ligand_coords(core_lig) -> np.ndarray:
    """[n, 3] coordinates of a core ligand: a parquet's rows, or the
    heavy atoms ``StructuralFileParser`` reads from a structure file."""
    if str(core_lig).endswith('.parquet'):
        core_df = pd.read_parquet(expand_path(core_lig))
    else:
        core_df = StructuralFileParser('ligand').file_to_parquets(core_lig)
    return np.stack([core_df.x, core_df.y, core_df.z], axis=1)


def constrained_attribution(model_path, rec, lig_files, core_lig=None,
                            attribution: str = 'atom_masking',
                            radius: float = 12, edge_radius: float = 4,
                            device: str = 'cuda') -> pd.DataFrame:
    """The ligand atoms of every ligand in the series with their
    ``attribution``, ``core_distance`` and ``ligand`` path, the model run
    on ``device``."""
    trainer, _, _ = load_model(model_path, resolve_device(device))
    per_lig_cores = mcs_core_coords(lig_files) if core_lig is None else None
    core_coords = (core_ligand_coords(core_lig) if core_lig is not None
                   else None)
    frames = []
    for lig in lig_files:
        if per_lig_cores is not None:
            core_coords = per_lig_cores.get(str(lig))
            if core_coords is None:
                continue
        scored = score_atoms(trainer, rec, lig,
                             ATTRIBUTION_FNS[attribution],
                             radius=radius, edge_radius=edge_radius)
        frame = distance_to_core(scored, core_coords)
        frame['ligand'] = str(lig)
        frames.append(frame)
    return pd.concat(frames, ignore_index=True)


def plot_distance_vs_score(df: pd.DataFrame, fname):
    """A scatter of attribution against core distance, saved to
    ``fname`` (needs matplotlib)."""
    from matplotlib import pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.scatter(df.core_distance, df.attribution, s=8, alpha=0.5)
    ax.set_xlabel('Distance from conserved core (A)')
    ax.set_ylabel('Attribution score')
    fig.savefig(expand_path(fname))
    return fig, ax


def main(argv=None) -> pd.DataFrame:
    ap = argparse.ArgumentParser()
    ap.add_argument('model')
    ap.add_argument('receptor')
    ap.add_argument('ligands', nargs='+')
    ap.add_argument('--core_ligand', default=None,
                    help='Core ligand file; without it the core is the '
                         'series\' maximum common substructure (RDKit)')
    ap.add_argument('--attribution', default='atom_masking')
    ap.add_argument('--output_dir', '-o', default='constrained_out')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)
    out = mkdir(args.output_dir)
    df = constrained_attribution(
        args.model, args.receptor, args.ligands,
        core_lig=args.core_ligand, attribution=args.attribution,
        device=args.device)
    df.to_csv(out / 'constrained_scores.csv', index=False)
    plot_distance_vs_score(df, out / 'distance_vs_score.png')
    LOG.info(f'Outputs in {out}')
    return df


if __name__ == '__main__':
    main()
