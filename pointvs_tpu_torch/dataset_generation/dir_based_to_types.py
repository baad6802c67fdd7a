"""A types file from a directory layout (the port's own copy of
``pointvs_tpu/dataset_generation/dir_based_to_types.py``).

Ligands under ``<base>/ligands/<rec>_{actives,decoys}/*.parquet`` are
labelled 1 (actives) or 0, paired with the first
``<base>/receptors/<rec>*.parquet``, and given the RMSD of
``rmsd_info.yaml`` (``<rec>: docked_wrt_crystal: {pose: rmsd}``) where the
base holds one, else -1. Paths are written relative to the base.

Usage:
    python -m pointvs_tpu_torch.dataset_generation.dir_based_to_types \\
        <directory> [-o out.types]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.utils import expand_path, load_yaml

LOG = get_logger()


def directory_to_types(base_path) -> str:
    """The types file's text for one base directory."""
    base_path = expand_path(base_path)

    def relative(p):
        return str(p).replace(str(base_path), '')[1:]

    rmsd_yaml = base_path / 'rmsd_info.yaml'
    rmsd_info = load_yaml(rmsd_yaml) if rmsd_yaml.is_file() else None

    rows = []
    for lig_fname in sorted(Path(base_path, 'ligands').glob('**/*.parquet')):
        suffix = lig_fname.parent.name.split('_')[-1]
        rec_name = lig_fname.parent.name.split('_')[0]
        matches = sorted(
            (base_path / 'receptors').glob(f'{rec_name}*.parquet'))
        if not matches:
            raise RuntimeError(
                f'Receptor for ligand {lig_fname} not found (looking for '
                f'{rec_name}.parquet)')
        label = 1 if suffix == 'actives' else 0
        rmsd = -1
        if rmsd_info is not None:
            pose_idx = lig_fname.name.split('.')[0].split('_')[-1]
            try:
                rmsd = rmsd_info[rec_name]['docked_wrt_crystal'][
                    int(pose_idx)]
            except (KeyError, ValueError):
                rmsd = -1
        rows.append(f'{label} {rmsd} {relative(matches[0])} '
                    f'{relative(lig_fname)}')
    return '\n'.join(rows) + ('\n' if rows else '')


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Write a types file from a ligands/receptors layout.')
    ap.add_argument('directory')
    ap.add_argument('--output_fname', '-o', default=None)
    args = ap.parse_args(argv)
    output_fname = Path(args.output_fname or Path(args.directory).name)
    if not output_fname.suffix:
        output_fname = output_fname.with_suffix('.types')
    expand_path(output_fname).write_text(directory_to_types(args.directory))
    LOG.info(f'Wrote {output_fname}')


if __name__ == '__main__':
    main()
