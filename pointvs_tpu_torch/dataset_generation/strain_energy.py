"""Ligand strain energies: MMFF dE from the lowest minimised conformer and
the RMSD to it, per docked pose (the port's own copy of
``pointvs_tpu/dataset_generation/strain_energy.py``). The results feed
``--include_strain_info`` training.

RDKit computes the force field. The module imports without it;
``find_delta_E`` raises ``ImportError`` and ``main`` exits, each naming
RDKit.

Usage (writes ``<data_root>/strain_energies.yaml``):
    python -m pointvs_tpu_torch.dataset_generation.strain_energy \\
        <data_root> <types_file>
"""
from __future__ import annotations

import argparse
import copy
from pathlib import Path

import numpy as np
import pandas as pd

from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.utils import expand_path, save_yaml

LOG = get_logger()

try:  # pragma: no cover - depends on image
    from rdkit import Chem
    from rdkit.Chem import AllChem, SDMolSupplier
    from rdkit.Chem.AllChem import CalcRMS
    HAVE_RDKIT = True
except ImportError:
    HAVE_RDKIT = False


def find_delta_E(sdf, multiple_structures: bool = False) -> dict:
    """{pose index: (dE, rmsd), or the reason as a string} for the
    structures of an sdf."""
    del multiple_structures  # every structure of the file is scored
    if not HAVE_RDKIT:
        raise ImportError('RDKit is required for strain energies.')

    supplier = list(SDMolSupplier(str(expand_path(sdf))))
    res, original_mols, original_energies = {}, {}, {}
    lowest_energy, lowest_energy_mol = np.inf, None
    for idx, mol in enumerate(supplier):
        if mol is None:
            res[idx] = 'unreadable'
            continue
        Chem.AddHs(mol)
        original_mols[idx] = mol
        minimising = copy.deepcopy(mol)
        if not AllChem.MMFFHasAllMoleculeParams(mol):
            res[idx] = 'unrecognised_atom_type'
            continue
        props = AllChem.MMFFGetMoleculeProperties(mol)
        try:
            ff = AllChem.MMFFGetMoleculeForceField(mol, props)
        except Exception:  # RDKit raises its own C++ exception types here
            res[idx] = 'forcefield_error'
            continue
        original_energy = ff.CalcEnergy()
        failed, opt_energy = AllChem.MMFFOptimizeMoleculeConfs(
            minimising, maxIters=1000000, nonBondedThresh=1000)[0]
        if failed:
            res[idx] = 'did_not_converge'
        else:
            if opt_energy < lowest_energy:
                lowest_energy, lowest_energy_mol = opt_energy, minimising
            original_energies[idx] = original_energy

    for idx, mol in original_mols.items():
        if idx in res:
            continue
        try:
            rmsd = CalcRMS(mol, lowest_energy_mol)
        except RuntimeError:
            res[idx] = 'no_common_substructure'
        else:
            res[idx] = (original_energies[idx] - lowest_energy, rmsd)
    return res


def find_sdfs(types_file, data_root):
    """The sorted unique sdf paths that a types file's ligands
    (``<stem>_<idx>.parquet``) come from."""
    data_root = str(data_root)
    with open(expand_path(types_file), 'r', encoding='utf-8') as f:
        n_fields = len(f.readline().split())
    cols = ['label', 'vinascore', 'rmsd', 'rec', 'lig']
    cols += [f'field_{i}' for i in range(len(cols), n_fields)]
    df = pd.read_csv(expand_path(types_file), sep=r'\s+', names=cols)
    sdfs = {str(Path(data_root, '_'.join(str(p).split('_')[:-1]) + '.sdf'))
            for p in df['lig']}
    return sorted(sdfs)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='MMFF strain energies of the poses of a types file.')
    ap.add_argument('data_root')
    ap.add_argument('types_file')
    args = ap.parse_args(argv)
    if not HAVE_RDKIT:
        raise SystemExit('RDKit is required for strain energies but is not '
                         'installed in this environment.')
    from rdkit import RDLogger
    RDLogger.DisableLog('rdApp.*')

    data_root = expand_path(args.data_root)
    energies = {}
    for sdf in find_sdfs(args.types_file, data_root):
        base = Path(sdf)
        base = str(Path(base.parent.name, base.with_suffix('').name))
        for idx, info in find_delta_E(sdf, True).items():
            key = f'{base}_{idx}.parquet'
            if isinstance(info, tuple):
                energies[key] = {'dE': info[0], 'rmsd': info[1]}
            else:
                energies[key] = {'dE': info, 'rmsd': info}
    save_yaml(energies, data_root / 'strain_energies.yaml')
    LOG.info(f"Saved to {data_root / 'strain_energies.yaml'}")


if __name__ == '__main__':
    main()
