"""Ligand decontamination by the Tanimoto similarity of Morgan
fingerprints (the port's own copy of
``pointvs_tpu/dataset_generation/ligand_clustering.py``).

RDKit computes the fingerprints. The module imports without it; every
function that needs it raises ``ImportError`` naming RDKit.

Usage (drops the train rows whose ligand is similar to a test ligand):
    python -m pointvs_tpu_torch.dataset_generation.ligand_clustering \\
        <pdbbind_tree> <test_pdbids> <train.types> <out.types> [-c 0.9]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import pandas as pd

from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.utils import expand_path, get_n_cols

LOG = get_logger()

try:  # pragma: no cover - depends on image
    from rdkit.Chem import AllChem, MolFromMol2File, SDMolSupplier
    from rdkit.DataStructs import TanimotoSimilarity, UIntSparseIntVect
    HAVE_RDKIT = True
except ImportError:
    HAVE_RDKIT = False


def _require_rdkit():
    if not HAVE_RDKIT:
        raise ImportError(
            'RDKit is required for ligand clustering but is not installed '
            'in this environment.')


def get_fingerprint(mol):
    """A molecule's Morgan (radius 3) fingerprint; a fingerprint as is."""
    _require_rdkit()
    if isinstance(mol, UIntSparseIntVect):
        return mol
    return AllChem.GetMorganFingerprint(mol, 3)


def is_similar(mol1, mol2, cutoff: float) -> bool:
    """Tanimoto similarity of the two fingerprints >= ``cutoff``."""
    _require_rdkit()
    return TanimotoSimilarity(
        get_fingerprint(mol1), get_fingerprint(mol2)) >= cutoff


def get_mol(sdf):
    """The fingerprint of an sdf's first molecule (the same-named mol2
    where the sdf cannot be read)."""
    _require_rdkit()
    mol = next(SDMolSupplier(str(sdf)), None)
    if mol is None:
        mol2 = str(sdf).replace('.sdf', '.mol2')
        if Path(mol2).is_file():
            mol = MolFromMol2File(mol2)
    if mol is None:
        raise RuntimeError(f'Molecule could not be read: {sdf}')
    return AllChem.GetMorganFingerprint(mol, 3)


def get_mols(directory, pdbid_file=None, types_file=None):
    """{pdbid: fingerprint} of the ligands of a PDBBind-style tree
    (``<dir>/<pdbid>/<pdbid>_ligand.sdf``), limited to the pdbids of
    ``pdbid_file`` and to the ligands a types file names."""
    _require_rdkit()
    if pdbid_file is None and types_file is None:
        raise ValueError('get_mols needs pdbid_file or types_file')
    ligs = None
    if types_file is not None:
        n_cols = get_n_cols(types_file)
        df = pd.read_csv(
            expand_path(types_file), sep=r'\s+',
            names=('x', 'y', 'z', 'rec', 'lig',
                   *[str(i) for i in range(max(0, n_cols - 5))]))
        ligs = {str(s).replace('.parquet', '.sdf') for s in df['lig']}
    pdbids = None
    if pdbid_file is not None:
        with open(expand_path(pdbid_file), 'r', encoding='utf-8') as f:
            pdbids = {s.strip() for s in f}

    mols, missing = {}, []
    for sdf in expand_path(directory).glob('*/*_ligand.sdf'):
        if pdbids is not None and sdf.parent.name not in pdbids:
            continue
        if ligs is not None:
            leaf = str(sdf.relative_to(expand_path(directory)))
            if leaf not in ligs:
                continue
        try:
            mols[sdf.parent.name] = get_mol(sdf)
        except RuntimeError:
            missing.append(sdf)
    if missing:
        LOG.warning(f'{len(missing)} ligands could not be read')
    return mols


def find_similar_pairs(test_mols: dict, train_mols: dict,
                       cutoff: float = 0.9):
    """The train keys whose ligand is similar to any test ligand."""
    _require_rdkit()
    contaminated = set()
    for train_key, train_fp in train_mols.items():
        for test_fp in test_mols.values():
            if TanimotoSimilarity(train_fp, test_fp) >= cutoff:
                contaminated.add(train_key)
                break
    return contaminated


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Drop train rows whose ligand resembles a test ligand.')
    ap.add_argument('directory', help='PDBBind-style structure tree')
    ap.add_argument('test_pdbids')
    ap.add_argument('train_types')
    ap.add_argument('output_types')
    ap.add_argument('--cutoff', '-c', type=float, default=0.9)
    args = ap.parse_args(argv)
    _require_rdkit()

    test_mols = get_mols(args.directory, pdbid_file=args.test_pdbids)
    train_mols = get_mols(args.directory, types_file=args.train_types)
    contaminated = find_similar_pairs(test_mols, train_mols, args.cutoff)
    LOG.info(f'{len(contaminated)} train ligands similar to test set')

    kept = []
    with open(expand_path(args.train_types), 'r', encoding='utf-8') as f:
        for line in f:
            if not any(pdbid in line for pdbid in contaminated):
                kept.append(line)
    with open(expand_path(args.output_types), 'w', encoding='utf-8') as f:
        f.writelines(kept)


if __name__ == '__main__':
    main()
