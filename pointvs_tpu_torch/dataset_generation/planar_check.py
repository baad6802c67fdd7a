"""Flag near-planar structures in a tree of parquets (the port's own copy
of ``pointvs_tpu/dataset_generation/planar_check.py``).

A structure is planar when the smallest singular value of its centred
coordinates, over its atom count, is below ``tolerance``: every atom lies
close to one plane. Fewer than four atoms are planar by definition.

Usage:
    python -m pointvs_tpu_torch.dataset_generation.planar_check <root> \\
        [--tolerance 1e-3]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import pandas as pd

from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.utils import expand_path

LOG = get_logger()


def is_planar(coords: np.ndarray, tolerance: float = 1e-3) -> bool:
    """True if all points lie within ``tolerance`` of a common plane."""
    coords = np.asarray(coords, dtype=np.float64)
    if len(coords) < 4:
        return True
    centred = coords - coords.mean(axis=0)
    singular_values = np.linalg.svd(centred, compute_uv=False)
    return bool(singular_values[-1] / len(coords) < tolerance)


def check_parquet(fname, tolerance: float = 1e-3) -> bool:
    df = pd.read_parquet(fname)
    return is_planar(np.stack([df.x, df.y, df.z], axis=1), tolerance)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Log the near-planar parquet structures under a tree.')
    ap.add_argument('root', help='Directory tree of parquet structures')
    ap.add_argument('--tolerance', type=float, default=1e-3)
    args = ap.parse_args(argv)
    flagged = 0
    for parquet in Path(expand_path(args.root)).glob('**/*.parquet'):
        if check_parquet(parquet, args.tolerance):
            LOG.warning(f'PLANAR: {parquet}')
            flagged += 1
    LOG.info(f'{flagged} planar structures found')


if __name__ == '__main__':
    main()
