"""Score the ligand sites of a PDB complex and write their attribution
artefacts (counterpart of ``pointvs_tpu/attribution/process_pdb.py``).

The sites are the file's HETATM residues that are not solvent, ions or
common additives, with at least 5 heavy atoms. As in the reference, a
site's atoms are collected by residue *name* alone, so copies of one
ligand (other chains or residue numbers) merge into every site of that
name (ROADMAP.md, Queue 3). Each site is written as a ligand parquet
beside the outputs and scored by ``attribution.score_atoms`` on the
model's device, which reads each input by its suffix (the reference's
parses both as structure files, refuses the parquet and so skips every
site; ROADMAP.md, Queue 3); ``score_and_colour_pdb`` writes the scores as
a CSV and as the B-factors of a copy of the PDB, and a PyMOL session
where PyMOL imports.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

from pointvs_tpu_torch.attribution.attribution import (
    colour_b_factors_pdb,
    score_atoms,
)
from pointvs_tpu_torch.dataset_generation.chem import parse_pdb
from pointvs_tpu_torch.utils import coords_to_string, expand_path, \
    get_logger, mkdir

LOG = get_logger()

try:
    import pymol  # noqa: F401
    HAVE_PYMOL = True
except ImportError:
    HAVE_PYMOL = False

# Residues never taken as a ligand site.
_EXCLUDED_HET = {'HOH', 'SO4', 'PO4', 'GOL', 'EDO', 'ACT', 'DMS', 'PEG',
                 'NA', 'CL', 'K', 'MG', 'CA', 'ZN', 'MN', 'FE', 'NI', 'CD'}


def find_ligand_sites(pdb_file) -> List[Tuple[str, pd.DataFrame]]:
    """``[(site id 'RESN:CHAIN:RESI', heavy atoms with x/y/z/atomic_number
    columns)]`` sorted by id, one per HETATM residue of at least 5 heavy
    atoms; every residue of one name gets the heavy atoms of all of them
    (the reference's merged sites)."""
    mol = parse_pdb(expand_path(pdb_file))
    het_keys = set()
    with open(expand_path(pdb_file), 'r', errors='replace') as f:
        for line in f:
            if line.startswith('HETATM'):
                res = line[17:20].strip()
                if res not in _EXCLUDED_HET:
                    het_keys.add((line[21], line[22:26].strip(), res))
    sites = {}
    for chain, resi, resn in het_keys:
        rows = [(atom.x, atom.y, atom.z, atom.element) for atom in mol.atoms
                if atom.residue_name == resn and atom.element != 1]
        if len(rows) >= 5:
            sites[f'{resn}:{chain}:{resi}'] = pd.DataFrame(
                rows, columns=['x', 'y', 'z', 'atomic_number'])
    return sorted(sites.items(), key=lambda item: item[0])


def score_pdb(trainer, attribution_fn, pdb_file, lig_file=None,
              output_dir='.', radius: float = 12, edge_radius: float = 4,
              only_process: Optional[str] = None) -> dict:
    """``{site id: scored frame}``: ``lig_file`` alone where given (keyed
    by its stem), else every site whose id starts with ``only_process``
    (all of them where None). A site that fails to score is logged and
    left out, as in the reference."""
    output_dir = mkdir(output_dir)
    if lig_file is not None:
        return {Path(lig_file).stem: score_atoms(
            trainer, pdb_file, lig_file, attribution_fn, radius=radius,
            edge_radius=edge_radius)}
    results = {}
    for site_id, lig_df in find_ligand_sites(pdb_file):
        if only_process and not site_id.startswith(only_process):
            continue
        lig_parquet = output_dir / f'{site_id.replace(":", "_")}.parquet'
        lig_df = lig_df.copy()
        lig_df['types'] = 10   # the catch-all ligand type
        lig_df['bp'] = 0
        lig_df[['x', 'y', 'z', 'atomic_number', 'types', 'bp']].to_parquet(
            lig_parquet)
        try:
            results[site_id] = score_atoms(
                trainer, pdb_file, lig_parquet, attribution_fn,
                radius=radius, edge_radius=edge_radius)
        except Exception as exc:  # noqa: BLE001 (the reference's skip)
            LOG.warning(f'Site {site_id} failed: {exc}')
    return results


def score_and_colour_pdb(trainer, attribution_fn, pdb_file, output_dir,
                         lig_file=None, radius: float = 12,
                         edge_radius: float = 4,
                         only_process: Optional[str] = None) -> dict:
    """Score the sites (``score_pdb``) and write, for each,
    ``<site>_scored.pdb`` (the scores as B-factors), ``<site>_scores.csv``
    and, where PyMOL imports, ``<site>.pse``; ``{site id: scored PDB}``."""
    output_dir = mkdir(output_dir)
    results = score_pdb(trainer, attribution_fn, pdb_file,
                        lig_file=lig_file, output_dir=output_dir,
                        radius=radius, edge_radius=edge_radius,
                        only_process=only_process)
    outputs = {}
    for site_id, scored in results.items():
        safe_id = site_id.replace(':', '_')
        out_pdb = output_dir / f'{safe_id}_scored.pdb'
        colour_b_factors_pdb(pdb_file, out_pdb, scored)
        scored.to_csv(output_dir / f'{safe_id}_scores.csv', index=False)
        outputs[site_id] = out_pdb
        if HAVE_PYMOL:
            from pointvs_tpu_torch.attribution.plip_subclasses import \
                render_attribution_pse
            ligname = site_id.split(':')[0] if ':' in site_id else None
            render_attribution_pse(
                out_pdb, output_dir / f'{safe_id}.pse',
                bfactors=_bfactor_map(scored), bonds=_top_bond_map(scored),
                ligname=ligname)
    return outputs


def _bfactor_map(scored: pd.DataFrame) -> dict:
    """``coords_to_string`` key -> attribution score, for PyMOL."""
    return {coords_to_string((x, y, z)): float(a) for x, y, z, a in zip(
        scored.x, scored.y, scored.z, scored.attribution)}


def _top_bond_map(scored: pd.DataFrame, top_n: int = 5,
                  max_dist: float = 4.0) -> dict:
    """The ``top_n`` highest-scoring ligand atoms, each paired with its
    closest receptor atom where that lies within ``max_dist``, as H-bond
    cylinder specs ``{'lig<i>-rec<j>': (coords, coords, score)}``."""
    lig = scored[scored.bp == 0]
    rec = scored[scored.bp == 1]
    if not len(lig) or not len(rec):
        return {}
    lig = lig.sort_values('attribution', ascending=False)[:top_n]
    rec_xyz = rec[['x', 'y', 'z']].to_numpy()
    bonds = {}
    for i, (x, y, z, score) in enumerate(zip(lig.x, lig.y, lig.z,
                                             lig.attribution)):
        d = np.sqrt(((rec_xyz - np.array([x, y, z])) ** 2).sum(1))
        j = int(d.argmin())
        if d[j] <= max_dist:
            bonds[f'lig{i}-rec{j}'] = ((x, y, z), tuple(rec_xyz[j]),
                                       float(score))
    return bonds
