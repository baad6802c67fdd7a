"""Types files from PDBBind-style directory trees of structures (the
port's own copy of ``pointvs_tpu/dataset_generation/generate_types_file.py``).

Each directory under ``base_path`` is one target; its files are matched
by regular expressions:

- a receptor and crystal + docked poses: each docked pose is labelled by
  its RMSD to the crystal pose (``obrms`` when it is on PATH, else an
  RMSD over heavy atoms in file order from ``chem.parse_sdf``),
  label = RMSD < 2 A;
- a receptor and active + inactive poses: labels 1 / 0 from the patterns;
- a receptor, a crystal pose and a PDBBind index (``--affinity``):
  regression rows ``pki pkd pic50 rec lig`` with the matching metric set.

Usage:
    python -m pointvs_tpu_torch.dataset_generation.generate_types_file \\
        <base_path> <output_path> -r REC_RE (-x XTAL_RE -d DOCKED_RE |
        -a ACTIVE_RE -i INACTIVE_RE | -x XTAL_RE -p INDEX.csv) [-s]
"""
from __future__ import annotations

import argparse
import io
import re
import shutil
from difflib import SequenceMatcher
from itertools import product
from pathlib import Path

import numpy as np
import pandas as pd

from pointvs_tpu_torch.dataset_generation.chem import parse_sdf
from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.utils import execute_cmd, expand_path, mkdir

LOG = get_logger()


def _naive_rmsd(ref_mol, docked_mol) -> float:
    """Heavy-atom RMSD with the atoms matched in file order (no symmetry
    correction); -1 when the heavy-atom counts differ."""
    ref = np.array([a.coords for a in ref_mol.atoms if a.element != 1])
    doc = np.array([a.coords for a in docked_mol.atoms if a.element != 1])
    if ref.shape != doc.shape:
        return -1.0
    return float(np.sqrt(np.mean(np.sum((ref - doc) ** 2, axis=1))))


def get_rmsd(reference_fname, docked_fname):
    """RMSDs between the first structure of one sdf and every structure of
    another."""
    reference_fname = expand_path(reference_fname)
    docked_fname = expand_path(docked_fname)
    if shutil.which('obrms'):
        out = execute_cmd(f'obrms {docked_fname} {reference_fname}',
                          raise_exceptions=False, silent=True)
        rmsds = []
        for line in out.stdout.decode('utf-8').split('\n'):
            chunks = line.split()
            if chunks and chunks[0] == 'RMSD':
                rmsds.append(float(chunks[-1]))
        return rmsds
    LOG.warning('obrms not found; using order-matched RMSD fallback')
    ref = parse_sdf(reference_fname)[0]
    return [_naive_rmsd(ref, mol) for mol in parse_sdf(docked_fname)]


def get_intra_rmsd(docked_fname):
    """{(i, j): RMSD} for every pair i < j of structures in one sdf."""
    docked_fname = expand_path(docked_fname)
    if shutil.which('obrms'):
        out = execute_cmd(f'obrms {docked_fname} -x', silent=True)
        lines = out.stdout.decode('utf-8').split('\n')[:-1]
        pairs = {}
        for i, line in enumerate(lines):
            rmsds = line.split(', ')[1:][i + 1:]
            for j, rmsd in enumerate(rmsds):
                pairs[(i, i + j + 1)] = rmsd
        return pairs
    mols = parse_sdf(docked_fname)
    return {(i, j): _naive_rmsd(mols[i], mols[j])
            for i in range(len(mols)) for j in range(i + 1, len(mols))}


def extract_pdbbind_affinities(csv) -> pd.DataFrame:
    """A PDBBind index (the 2016 CSV or the 2020 text layout) -> columns
    pdbid, affinity, metric (``pkd``, ``pki`` or ``pic50``)."""

    def metric_of(affinity):
        for split_char in '<>=~':
            if split_char in str(affinity):
                return 'p' + str(affinity).split(split_char)[0].lower()
        return None

    lines, header_idx, year = [], 0, 2020
    with open(expand_path(csv), 'r', encoding='utf-8') as f:
        for idx, line in enumerate(f):
            if line.startswith('#'):
                lines.append(line.strip())
                header_idx = idx
            elif idx:
                break
            elif line.startswith('ID'):
                year = 2016

    if year == 2020:
        names = lines[-1][2:].split(', ')[:5] if lines else \
            ['PDB code', 'resolution', 'release year', '-logKd/Ki', 'Kd/Ki']
        with open(expand_path(csv), 'r', encoding='utf-8') as f:
            body = '\n'.join(' '.join(line.split()[:5]) for line in f)
        df = pd.read_csv(io.StringIO(body), sep=r'\s+',
                         header=header_idx, names=names)
        affinity_field, pk_field = 'Kd/Ki', '-logKd/Ki'
    else:
        names = ('ID', 'PDB code', 'Subset', 'Affinity Data',
                 'pKd pKi pIC50', 'Ligand Name')
        df = pd.read_csv(expand_path(csv), sep=',', names=names)
        affinity_field, pk_field = 'Affinity Data', 'pKd pKi pIC50'

    return pd.DataFrame({
        'pdbid': df['PDB code'],
        'affinity': df[pk_field],
        'metric': df[affinity_field].map(metric_of),
    })


def _best_substring_match(candidates, target_name):
    """The candidate whose stem shares the longest common substring with
    ``target_name`` (the first on ties; None if none shares any)."""
    best, best_len = None, 0
    for cand in candidates:
        name = cand.with_suffix('').name
        match = SequenceMatcher(None, name, target_name).find_longest_match(
            0, len(name), 0, len(target_name))
        if match.size > best_len:
            best, best_len = cand, match.size
    return best


def generate_types_str(directory, pdb_exp, crystal_exp=None, docked_exp=None,
                       active_exp=None, inactive_exp=None,
                       include_crystal_structure: bool = True,
                       separated_files: bool = True, affinity_dict=None):
    """The types rows of one target directory, or -1 if no file matches
    ``pdb_exp``."""
    directory = expand_path(directory)

    def re_glob(exp):
        return [f for f in directory.glob('*')
                if f.is_file() and re.match(exp, str(f.name))]

    def rec_path(receptor_pdb):
        return Path(directory.name, receptor_pdb.with_suffix('.parquet').name)

    def lig_path(sdf, idx):
        return Path(directory.name,
                    sdf.with_suffix('').name + f'_{idx}.parquet')

    def classification_lines(receptor_pdb, ref_sdf=None, query_sdf=None,
                             label=None, ics=True):
        template = '{0} -1 {1} {2} {3}\n'
        if label is None:
            rmsds = get_rmsd(ref_sdf, query_sdf)
        else:
            rmsds = [-1] * len(parse_sdf(query_sdf))
        res = ''
        if include_crystal_structure and ics and ref_sdf is not None:
            res += template.format(1, '0.00000', rec_path(receptor_pdb),
                                   lig_path(ref_sdf, 0))
        for idx, rmsd in enumerate(rmsds):
            res += template.format(
                int(rmsd < 2.0) if label is None else label, rmsd,
                rec_path(receptor_pdb), lig_path(query_sdf, idx))
        return res

    def regression_line(receptor_pdb, ligand_sdf, affinity, metric):
        affinities = [-1, -1, -1]
        try:
            affinities[['pki', 'pkd', 'pic50'].index(metric)] = affinity
        except (ValueError, IndexError):
            LOG.warning(f'Could not find affinity data for {receptor_pdb}')
            return None
        return '{0} {1} {2} {3} {4}\n'.format(
            *affinities, rec_path(receptor_pdb), lig_path(ligand_sdf, 0))

    pdbs = re_glob(pdb_exp)
    if not pdbs:
        return -1
    out = ''
    for receptor_pdb in pdbs:
        receptor_name = receptor_pdb.with_suffix('').name
        if crystal_exp is not None and docked_exp is not None:
            xtal = re_glob(crystal_exp)
            docked = re_glob(docked_exp)
            types_str = ''
            if len(xtal) * len(docked) == 1:
                types_str = classification_lines(
                    receptor_pdb, xtal[0], docked[0], None)
            elif xtal and docked and not separated_files:
                types_str = classification_lines(
                    receptor_pdb,
                    _best_substring_match(xtal, receptor_name),
                    _best_substring_match(docked, receptor_name), None)
            elif xtal and docked:
                for idx, (x, d) in enumerate(product(xtal, docked)):
                    types_str += classification_lines(
                        receptor_pdb, x, d, None, ics=not idx)
            else:
                # Crystal to docked by the longest common substring.
                mapping = {}
                for x in xtal:
                    match = _best_substring_match(
                        docked, x.with_suffix('').name)
                    if match is not None:
                        mapping[x] = match
                if len(set(mapping.values())) != len(xtal):
                    raise RuntimeError(
                        f'Could not determine matching pattern for '
                        f'{directory}')
                for x, d in mapping.items():
                    types_str += classification_lines(receptor_pdb, x, d)
        elif active_exp is not None and inactive_exp is not None:
            types_str = ''
            for active in re_glob(active_exp):
                types_str += classification_lines(
                    receptor_pdb, query_sdf=active, label=1)
            for inactive in re_glob(inactive_exp):
                types_str += classification_lines(
                    receptor_pdb, query_sdf=inactive, label=0)
        elif crystal_exp is not None and affinity_dict:
            types_str = ''
            xtal = re_glob(crystal_exp)
            if not xtal:
                continue
            pdbid = next((receptor_name[i:i + 4]
                          for i in range(len(receptor_name) - 3)
                          if receptor_name[i:i + 4] in affinity_dict), None)
            if pdbid is None:
                LOG.warning(f'No affinity data for pdb {receptor_pdb}')
                continue
            affinity, metric = affinity_dict[pdbid]
            line = regression_line(receptor_pdb, xtal[0], affinity, metric)
            if line:
                types_str += line
        else:
            raise RuntimeError(
                'Either specify both crystal_exp and docked_exp or '
                'active_exp and inactive_exp')
        out += types_str + '\n'
    return out[:-1]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Write a types file from a tree of target directories.')
    ap.add_argument('base_path')
    ap.add_argument('output_path')
    ap.add_argument('--receptor_pattern', '-r')
    ap.add_argument('--crystal_pose_pattern', '-x')
    ap.add_argument('--docked_pose_pattern', '-d')
    ap.add_argument('--active_pattern', '-a')
    ap.add_argument('--inactive_pattern', '-i')
    ap.add_argument('--split_sdfs', '-s', action='store_true')
    ap.add_argument('--affinity', '-p', default=None,
                    help='PDBBind affinity CSV (regression mode)')
    args = ap.parse_args(argv)

    base_path = expand_path(args.base_path)
    output_path = mkdir(args.output_path)

    affinity_dict = None
    if args.affinity:
        adf = extract_pdbbind_affinities(args.affinity)
        affinity_dict = {p: (a, m) for p, a, m in zip(
            adf.pdbid, adf.affinity, adf.metric)}

    out = ''
    targets = [p for p in base_path.glob('*') if p.is_dir()]
    for idx, path in enumerate(targets):
        rows = generate_types_str(
            path, args.receptor_pattern, args.crystal_pose_pattern,
            args.docked_pose_pattern, args.active_pattern,
            args.inactive_pattern, separated_files=args.split_sdfs,
            affinity_dict=affinity_dict)
        if rows != -1:
            out += rows.strip()
            if args.split_sdfs:
                out += '\n'
        if not (idx + 1) % 10:
            LOG.info(f'Completed {idx + 1}/{len(targets)} targets')

    out = '\n'.join(l for l in out.split('\n') if len(l.split()) > 1)
    target = output_path / (output_path.parent.name + '.types')
    target.write_text(out)
    LOG.info(f'Types file written to {target}')


if __name__ == '__main__':
    main()
