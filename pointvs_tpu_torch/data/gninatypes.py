"""Binary ``.gninatypes`` files -> parquet (the port's own copy of
``pointvs_tpu/data/gninatypes.py``).

A gninatypes file is a run of packed ``(x, y, z: float32, type: int32)``
records. Receptor types are offset by the 14 channels of the gnina map and
get ``bp`` 1; ligands keep their types and get ``bp`` 0. ``get_type_map``
is the legacy collapse of the smina table (``types_to_parquet``) onto
those channels.

Usage (every ``*.gninatypes`` under a tree, mirrored as parquets):
    python -m pointvs_tpu_torch.data.gninatypes <base_path> <output_dir> \\
        {receptor,ligand}
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import pandas as pd

from pointvs_tpu_torch.dataset_generation.types_to_parquet import (
    SMINA_ATOM_TYPES,
    TYPE_GROUPS,
)
from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.utils import expand_path, mkdir, no_return_parallelise

LOG = get_logger()

GNINA_N_ATOM_TYPES = 14
# One record, native byte order as gnina writes it; the frame widens it to
# float64 coordinates and int64 types.
_RECORD = np.dtype([('x', 'f4'), ('y', 'f4'), ('z', 'f4'), ('t', 'i4')])


def get_type_map(groups=None):
    """smina type index -> collapsed channel (one generic channel for the
    rest). The legacy map's sulfur group has no selenium."""
    if groups is None:
        groups = [g if 'Selenium' not in g else ['Sulfur', 'SulfurAcceptor']
                  for g in TYPE_GROUPS]
    out = {}
    for i, info in enumerate(SMINA_ATOM_TYPES):
        out[i] = next((k for k, group in enumerate(groups)
                       if info.sm in group), len(groups))
    return out


def gninatypes_to_parquet(input_filename, output_filename,
                          struct_type: str):
    """One gninatypes file -> a parquet with columns x, y, z, types, bp."""
    bp_int = 1 if struct_type == 'receptor' else 0
    records = np.fromfile(input_filename, dtype=_RECORD)
    coords = np.stack([records['x'], records['y'], records['z']],
                      axis=1).astype(np.float64).reshape(-1, 3)
    df = pd.DataFrame(coords, columns=['x', 'y', 'z'])
    df['types'] = records['t'].astype(np.int64) + bp_int * GNINA_N_ATOM_TYPES
    df['bp'] = bp_int
    Path(output_filename).parent.mkdir(parents=True, exist_ok=True)
    df.to_parquet(output_filename)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Convert .gninatypes files under a tree to parquets.')
    ap.add_argument('base_path')
    ap.add_argument('output_dir')
    ap.add_argument('structure_type', choices=('receptor', 'ligand'))
    args = ap.parse_args(argv)
    output_dir = mkdir(args.output_dir)
    input_dir = expand_path(args.base_path)
    inputs, outputs = [], []
    for gt in input_dir.glob('**/*.gninatypes'):
        inputs.append(str(gt))
        outputs.append(str(
            output_dir / gt.relative_to(input_dir).with_suffix('.parquet')))
    no_return_parallelise(
        gninatypes_to_parquet, inputs, outputs, args.structure_type)
    LOG.info(f'Converted {len(inputs)} gninatypes files')


if __name__ == '__main__':
    main()
