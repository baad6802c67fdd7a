"""Hotspot maps: receptor atoms ranked by their mean attribution over
many fragments bound to one receptor (counterpart of
``pointvs_tpu/attribution/hotspot.py``).

``multiple_ligands.rank_protein_atoms`` scores each (receptor, fragment)
pair on the model's device; the positions seen in at least two complexes
head the table of hotspots. With ``--apo_protein`` the scores are mapped
onto that structure's atoms by position and each atom is typed as an
H-bond acceptor, donor or neither from its smina type; the top acceptors
and donors are written as fake-atom molecules (phosphorus and iodine),
through RDKit where it imports and through a plain V2000 writer
otherwise.

Usage:
    python -m pointvs_tpu_torch.attribution.hotspot <run_dir> <receptor> \\
        <fragment> [<fragment> ...] [--attribution atom_masking] \\
        [-o hotspot_out] [--top_n 20] [--apo_protein <pdb>] [-c 7] [-i] \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import pandas as pd

from pointvs_tpu_torch.attribution.attribution_fns import ATTRIBUTION_FNS
from pointvs_tpu_torch.attribution.multiple_ligands import rank_protein_atoms
from pointvs_tpu_torch.constants import AA_TRIPLET_CODES, VDW_RADII
from pointvs_tpu_torch.dataset_generation.types_to_parquet import \
    StructuralFileParser
from pointvs_tpu_torch.device import resolve_device
from pointvs_tpu_torch.models.load_model import load_model
from pointvs_tpu_torch.utils import PositionDict, expand_path, get_logger, \
    mkdir

LOG = get_logger()


def hotspot_pharmacophores(rank_df: pd.DataFrame, top_n: int = 20,
                           min_complexes: int = 2) -> pd.DataFrame:
    """The first ``top_n`` positions seen in at least ``min_complexes``
    complexes."""
    df = rank_df[rank_df.n_complexes >= min_complexes]
    return df.head(top_n).reset_index(drop=True)


def write_fake_atom_mol(df: pd.DataFrame, fname, element: str = 'Du'):
    """The positions of ``df`` as one V2000 molecule of ``element`` atoms
    without bonds."""
    lines = ['hotspots', '  PointVS-TPU', '',
             f'{len(df):3d}{0:3d}  0  0  0  0  0  0  0  0999 V2000']
    for x, y, z in zip(df.x, df.y, df.z):
        lines.append(f'{x:10.4f}{y:10.4f}{z:10.4f} {element:<3s}'
                     f'0  0  0  0  0  0  0  0  0  0  0  0')
    lines += ['M  END', '$$$$', '']
    Path(expand_path(fname)).write_text('\n'.join(lines))


def pharmacophore_from_smina_type(smina_type: str,
                                  lig_pharm: str = 'none') -> str:
    """A smina atom type's class: 'hba', 'hbd' or 'none'. An O, N or S
    that is not typed further, or a DonorAcceptor, takes the class that
    complements the interacting ligand's (``lig_pharm``) where known."""
    if smina_type in ('Oxygen', 'Nitrogen', 'Sulfur') or \
            smina_type.endswith('DonorAcceptor'):
        return {'hba': 'hbd', 'hbd': 'hba'}.get(lig_pharm, 'none')
    if smina_type.endswith('Donor'):
        return 'hbd'
    if smina_type.endswith('Acceptor'):
        return 'hba'
    return 'none'


def scores_to_pharmacophore_df(reference_structure, rank_df: pd.DataFrame,
                               use_rank: bool = False) -> pd.DataFrame:
    """Every atom of ``reference_structure`` that is not in a non-standard
    residue, with x, y, z, vdw_radius, smina_type, pharmacophore and the
    score ``rank_df`` gives its position (within 0.01 A; -inf where it
    has none, +inf with ``use_rank``), sorted by score (best first)."""
    score_of = PositionDict(eps=1e-2)
    lig_pharm_of = PositionDict(eps=1e-2)
    for _, row in rank_df.iterrows():
        key = (row.x, row.y, row.z)
        score_of[key] = float(row.get('mean_attribution',
                                      row.get('mean_score', 0.0)))
        lig_pharm_of[key] = row.get('lig_pharm', 'none')

    parser = StructuralFileParser('receptor')
    mol = parser.read_file(reference_structure)[0]
    rows = []
    missing_score = (-1) ** (1 - use_rank) * np.inf
    for x, y, z, atomic_num, smina_type, resname in \
            parser.mol_typed_atoms(mol):
        if resname and resname not in AA_TRIPLET_CODES:
            continue
        key = (x, y, z)
        rows.append({
            'x': x, 'y': y, 'z': z,
            'vdw_radius': VDW_RADII.get(atomic_num, 1.5),
            'smina_type': smina_type,
            'pharmacophore': pharmacophore_from_smina_type(
                smina_type, lig_pharm_of.get(key, 'none')),
            'score': score_of.get(key, missing_score)})
    return pd.DataFrame(rows).sort_values(
        'score', ascending=use_rank).reset_index(drop=True)


def pharmacophore_df_to_mols(df: pd.DataFrame, use_rank: bool = False,
                             cutoff: int = 0,
                             include_donor_acceptors: bool = False):
    """(acceptors, donors) as RDKit molecules of phosphorus and iodine
    atoms at the best-scoring positions (the first ``cutoff`` of each,
    finite and, unless ``use_rank``, positive), with their scores and
    radii as the properties 'score' and 'vdw'. Needs RDKit (raises
    ``ImportError`` without it)."""
    from rdkit import Chem
    res = []
    included = [['hba'], ['hbd']]
    if include_donor_acceptors:
        included[0].append('hbda')
        included[1].append('hbda')
    for atom_type, pharm_types in zip(('P', 'I'), included):
        sub = df[df['pharmacophore'].isin(pharm_types)].copy()
        sub.sort_values(by='score', ascending=use_rank, inplace=True)
        if cutoff:
            sub = sub[:cutoff]
        sub = sub[np.isfinite(sub['score'])]
        if not use_rank:
            sub = sub[sub['score'] > 0]
        if not len(sub):
            res.append(Chem.RWMol())
            continue
        mol = Chem.MolFromSmiles(atom_type * len(sub))
        conf = Chem.Conformer(mol.GetNumAtoms())
        for idx, (x, y, z) in enumerate(zip(sub.x, sub.y, sub.z)):
            conf.SetAtomPosition(idx, [x, y, z])
        conf.SetId(0)
        mol.AddConformer(conf)
        mol.SetProp('score', '\n'.join(str(s) for s in sub['score']))
        mol.SetProp('vdw', '\n'.join(str(v) for v in sub['vdw_radius']))
        res.append(mol)
    return tuple(res)


def main(argv=None) -> pd.DataFrame:
    ap = argparse.ArgumentParser()
    ap.add_argument('model')
    ap.add_argument('receptor')
    ap.add_argument('fragments', nargs='+',
                    help='Fragment ligand files bound to the receptor')
    ap.add_argument('--attribution', default='atom_masking')
    ap.add_argument('--output_dir', '-o', default='hotspot_out')
    ap.add_argument('--top_n', type=int, default=20)
    ap.add_argument('--apo_protein', default=None,
                    help='Structure whose atoms the scores are mapped onto '
                         'and typed (writes typed_pharmacophores.csv, '
                         'hba.sdf and hbd.sdf)')
    ap.add_argument('--cutoff', '-c', type=int, default=7,
                    help='Top-scoring acceptors and donors written')
    ap.add_argument('--include_donor_acceptors', '-i', action='store_true')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)

    out = mkdir(args.output_dir)
    trainer, _, _ = load_model(args.model, resolve_device(args.device))
    ranks = rank_protein_atoms(
        trainer, args.receptor, args.fragments,
        ATTRIBUTION_FNS[args.attribution])
    ranks.to_csv(out / 'hotspot_ranks.csv', index=False)
    pharm = hotspot_pharmacophores(ranks, top_n=args.top_n)
    pharm.to_csv(out / 'pharmacophores.csv', index=False)
    write_fake_atom_mol(pharm, out / 'hotspots.sdf')

    if args.apo_protein:
        typed = scores_to_pharmacophore_df(args.apo_protein, ranks)
        typed.to_csv(out / 'typed_pharmacophores.csv', index=False)
        try:
            hba, hbd = pharmacophore_df_to_mols(
                typed, cutoff=args.cutoff,
                include_donor_acceptors=args.include_donor_acceptors)
            from rdkit import Chem
            for mol, name in ((hba, 'hba.sdf'), (hbd, 'hbd.sdf')):
                with Chem.SDWriter(str(out / name)) as w:
                    w.write(mol)
        except ImportError:
            # Without RDKit: the same positions by the plain writer.
            for pharm_type, element in (('hba', 'P'), ('hbd', 'I')):
                sub = typed[typed.pharmacophore == pharm_type][:args.cutoff]
                write_fake_atom_mol(sub, out / f'{pharm_type}.sdf',
                                    element=element)
    LOG.info(f'Hotspot outputs in {out}')
    return ranks


if __name__ == '__main__':
    main()
