"""Hydrogen bonds along an MD trajectory against the model's bond
attributions (counterpart of ``pointvs_tpu/attribution/gromacs.py``).

The GROMACS outputs are parsed here (``.xvg`` time series, ``hbond.ndx``
index files, ``.gro`` structures); each tracked bond's distance
statistics are correlated (Spearman) with the model's bond scores. Running
GROMACS itself (``run_gmx_hbond``) needs the ``gmx`` binary, and the
trajectory movie (``make_pymol_movie``) needs PyMOL; both stop with
``SystemExit`` without them. No model runs here.

Usage:
    python -m pointvs_tpu_torch.attribution.gromacs <hbnum.xvg> \\
        <bond_scores.csv> [-o gromacs_out] [--gro_file frame.gro] \\
        [--movie_frames f1.pdb f2.pdb ...]
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import pandas as pd

from pointvs_tpu_torch.utils import PositionDict, execute_cmd, expand_path, \
    get_logger, mkdir

LOG = get_logger()


def parse_xvg(fname) -> pd.DataFrame:
    """A GROMACS ``.xvg`` time series: columns ``time``, ``value_0``, ...
    (empty where the file has no data rows)."""
    rows = []
    with open(expand_path(fname), 'r', encoding='utf-8') as f:
        for line in f:
            if line.startswith(('#', '@')):
                continue
            chunks = line.split()
            if chunks:
                rows.append([float(c) for c in chunks])
    if not rows:
        return pd.DataFrame()
    cols = ['time'] + [f'value_{i}' for i in range(len(rows[0]) - 1)]
    return pd.DataFrame(rows, columns=cols)


def parse_hbond_ndx(fname) -> list:
    """The (donor, hydrogen, acceptor) atom indices of the ``hbonds``
    sections of a GROMACS ``hbond.ndx``."""
    bonds = []
    in_section = False
    with open(expand_path(fname), 'r', encoding='utf-8') as f:
        for line in f:
            if line.startswith('['):
                in_section = 'hbonds' in line.lower()
                continue
            if in_section:
                chunks = line.split()
                if len(chunks) == 3:
                    bonds.append(tuple(int(c) for c in chunks))
    return bonds


def bond_distance_stats(xvg_df: pd.DataFrame) -> pd.DataFrame:
    """Per tracked distance column: mean, standard deviation and the
    fraction of frames below 0.35 nm."""
    stats = []
    for col in xvg_df.columns:
        if col == 'time':
            continue
        vals = xvg_df[col].to_numpy()
        stats.append({'bond': col, 'mean': float(vals.mean()),
                      'std': float(vals.std()),
                      'fraction_below_3.5': float((vals < 0.35).mean())})
    return pd.DataFrame(stats)


def gro_to_pdb(input_file, output_file) -> None:
    """A GROMACS ``.gro`` structure as a PDB (nm to Angstrom; water as
    HETATM). A file this reader cannot parse goes to GROMACS' own
    ``editconf`` where it is installed, and raises otherwise."""
    input_file = expand_path(input_file)
    output_file = expand_path(output_file)
    try:
        lines = open(input_file, 'r', encoding='utf-8').read().splitlines()
        natoms = int(lines[1].split()[0])
        out = []
        for serial, line in enumerate(lines[2:2 + natoms], start=1):
            resid = int(line[0:5])
            resname = line[5:10].strip()
            name = line[10:15].strip()
            x, y, z = (float(line[c:c + 8]) * 10 for c in (20, 28, 36))
            record = 'ATOM  ' if resname.upper() != 'HOH' else 'HETATM'
            element = ''.join(c for c in name if c.isalpha())[:2]
            element = (element[0] if len(element) > 1
                       and element[1].islower() else element)[:2]
            out.append(
                f'{record}{serial:5d} {name:<4.4s} {resname:<3.3s} A'
                f'{resid % 10000:4d}    {x:8.3f}{y:8.3f}{z:8.3f}'
                f'  1.00  0.00          {element:>2.2s}')
        out.append('END')
        Path(output_file).write_text('\n'.join(out) + '\n')
    except (ValueError, IndexError):
        if not (shutil.which('editconf') or shutil.which('gmx')):
            raise
        binary = 'editconf' if shutil.which('editconf') else 'gmx editconf'
        # editconf writes to stderr even when it succeeds
        execute_cmd(f'{binary} -f {input_file} -o {output_file}',
                    raise_exceptions=False)


def parse_gromacs_file(gromacs_file) -> PositionDict:
    """A ``.gro`` file's atoms as a map from (x, y, z) in Angstrom (to
    0.01) to ``'resi:resn:name'``, water left out; raises
    ``RuntimeError`` where two atoms share an identifier."""
    gromacs_file = expand_path(gromacs_file)
    lines = open(gromacs_file, 'r', encoding='utf-8').read().splitlines()
    natoms = int(lines[1].split()[0])
    result = PositionDict(eps=0.01)
    seen = set()
    for line in lines[2:2 + natoms]:
        resid = line[0:5].strip()
        resname = line[5:10].strip()
        name = line[10:15].strip()
        if resname.lower() == 'hoh':
            continue
        coords = tuple(float(line[c:c + 8]) * 10 for c in (20, 28, 36))
        key = (resid, resname, name)
        if key in seen:
            raise RuntimeError(
                f'Cannot determine unique mapping for {gromacs_file}')
        seen.add(key)
        result[coords] = f'{resid}:{resname}:{name}'
    return result


def remove_solvent_pdb(pdb_file) -> None:
    """Drop the water, solvent and ion records of a PDB file in place."""
    solvent = {'HOH', 'WAT', 'SOL', 'TIP', 'T3P', 'NA', 'CL', 'K', 'MG',
               'ZN', 'CA', 'MN', 'FE'}
    pdb_file = expand_path(pdb_file)
    kept = []
    for line in open(pdb_file, 'r', encoding='utf-8'):
        if line.startswith(('ATOM', 'HETATM')) \
                and line[17:20].strip().upper() in solvent:
            continue
        kept.append(line)
    Path(pdb_file).write_text(''.join(kept))


def make_pymol_movie(pdb_files, output_file, ray: bool = False) -> None:
    """Render PDB frames as a movie with PyMOL; ``SystemExit`` without
    PyMOL."""
    del ray
    try:
        import pymol
    except ImportError as exc:
        raise SystemExit(
            'PyMOL is not installed: the movie export needs the pymol '
            'package (pymol-open-source)') from exc
    pymol.finish_launching(['pymol', '-qc'])
    for idx, fname in enumerate(pdb_files):
        pymol.cmd.load(str(expand_path(fname)), 'traj', state=idx + 1)
    pymol.cmd.remove('resn hoh')
    pymol.cmd.remove('solvent')
    pymol.cmd.mset(f'1 -{len(pdb_files)}')
    pymol.cmd.movie.produce(str(expand_path(output_file)),
                            quality=90, preserve=0)
    pymol.cmd.delete('all')


def run_gmx_hbond(tpr, xtc, output_dir) -> Path:
    """GROMACS' hydrogen-bond analysis of a trajectory into
    ``output_dir`` (``hbnum.xvg``, ``hbond.ndx``); ``SystemExit`` without
    ``gmx`` on the PATH."""
    if not shutil.which('gmx'):
        raise SystemExit('gmx binary not found on PATH: install GROMACS '
                         'or supply precomputed .xvg/.ndx files.')
    output_dir = mkdir(output_dir)
    execute_cmd(
        f'echo "1 13" | gmx hbond -s {tpr} -f {xtc} '
        f'-num {output_dir}/hbnum.xvg -hbn {output_dir}/hbond.ndx',
        raise_exceptions=False)
    return output_dir


def correlate_md_with_attribution(bond_stats: pd.DataFrame,
                                  bond_scores: pd.DataFrame):
    """(Spearman's rho, p) between the bonds' fraction of frames formed
    and their scores, joined on ``bond``; (nan, 1) under 3 bonds."""
    from scipy.stats import spearmanr
    merged = bond_stats.merge(bond_scores, on='bond')
    if len(merged) < 3:
        return float('nan'), 1.0
    rho, p = spearmanr(merged['fraction_below_3.5'], merged['score'])
    return float(rho), float(p)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('hbnum_xvg', help='GROMACS hbond distance xvg')
    ap.add_argument('bond_scores_csv',
                    help='CSV with bond, score columns (bond attributions)')
    ap.add_argument('--output_dir', '-o', default='gromacs_out')
    ap.add_argument('--gro_file', default=None,
                    help='A .gro structure: written as a PDB without '
                         'solvent beside the outputs, with its atom '
                         'identifiers as a CSV')
    ap.add_argument('--movie_frames', nargs='*', default=None,
                    help='PDB frames to render as a movie (needs PyMOL)')
    args = ap.parse_args(argv)
    out = mkdir(args.output_dir)
    stats = bond_distance_stats(parse_xvg(args.hbnum_xvg))
    stats.to_csv(out / 'bond_stats.csv', index=False)
    scores = pd.read_csv(args.bond_scores_csv)
    rho, p = correlate_md_with_attribution(stats, scores)
    LOG.info(f'Spearman rho={rho:.4f} (p={p:.4g})')
    if args.gro_file:
        pdb_out = out / (Path(args.gro_file).stem + '.pdb')
        gro_to_pdb(args.gro_file, pdb_out)
        remove_solvent_pdb(pdb_out)
        id_map = parse_gromacs_file(args.gro_file)
        pd.DataFrame(
            [{'coords': k, 'atom_id': v} for k, v in id_map.items()]
        ).to_csv(out / 'gro_atom_ids.csv', index=False)
        LOG.info(f'Converted {args.gro_file} -> {pdb_out}')
    if args.movie_frames:
        make_pymol_movie(args.movie_frames, out / 'trajectory.mpg')
    return rho, p


if __name__ == '__main__':
    main()
