"""Protein sequence-similarity decontamination with CD-HIT (the port's own
copy of ``pointvs_tpu/dataset_generation/protein_clustering.py``).

Filters a PDB-wide FASTA down to the train and test pdbids, runs
``cd-hit-2d`` between the two sets, and drops the train types rows whose
proteins are similar to a test protein. Needs the ``cd-hit-2d`` binary on
PATH.

Usage (writes ``<output_dir>/<train_types stem>_unbiased.types``):
    python -m pointvs_tpu_torch.dataset_generation.protein_clustering \\
        <fasta> <test_pdbids> <train_pdbids> <output_dir> <train_types> \\
        [-t 0.9]
"""
from __future__ import annotations

import argparse
import shutil

from pointvs_tpu_torch.dataset_generation.split_by_cdhit_output import (
    cdhit_output_to_graph,
)
from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.utils import execute_cmd, expand_path, mkdir

LOG = get_logger()


def filter_fasta_file(fasta_file, pdbids_file, output_file):
    """Keep the FASTA records whose pdbid (the header's first four
    characters, any case) is listed in ``pdbids_file``."""
    with open(expand_path(pdbids_file), 'r', encoding='utf-8') as f:
        pdbids = {s.strip().lower() for s in f}
    out = []
    pdbid, buffer = None, []
    with open(expand_path(fasta_file), 'r', encoding='utf-8') as f:
        for line in f:
            if line.startswith('>'):
                pdbid = line[1:5].lower()
                buffer = [line]
            elif pdbid is not None:
                buffer.append(line)
                if pdbid in pdbids:
                    out.extend(buffer)
                buffer = []
    with open(expand_path(output_file), 'w', encoding='utf-8') as f:
        f.writelines(out)


def decontaminate_types(types_file, similar_pdbids, output_file):
    """Copy a types file without the rows that name any of the pdbids."""
    kept = []
    with open(expand_path(types_file), 'r', encoding='utf-8') as f:
        for line in f:
            lower = line.lower()
            if not any(pdbid in lower for pdbid in similar_pdbids):
                kept.append(line)
    with open(expand_path(output_file), 'w', encoding='utf-8') as f:
        f.writelines(kept)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Drop train rows similar to the test set (cd-hit-2d).')
    ap.add_argument('fasta', help='PDB sequences in FASTA format')
    ap.add_argument('test_pdbids')
    ap.add_argument('train_pdbids')
    ap.add_argument('output_dir')
    ap.add_argument('train_types')
    ap.add_argument('--threshold', '-t', default=0.9, type=float)
    args = ap.parse_args(argv)

    if not shutil.which('cd-hit-2d'):
        raise SystemExit('cd-hit-2d binary not found on PATH — install '
                         'CD-HIT to use protein clustering.')

    output_dir = mkdir(args.output_dir)
    train_fasta = output_dir / 'train.fasta'
    test_fasta = output_dir / 'test.fasta'
    filter_fasta_file(args.fasta, args.train_pdbids, train_fasta)
    filter_fasta_file(args.fasta, args.test_pdbids, test_fasta)

    execute_cmd(
        f'cd-hit-2d -i {test_fasta} -i2 {train_fasta} '
        f'-o {output_dir / "cdhit_output"} -c {args.threshold} '
        f'-M 80000 -b 20 -T 0 -n 5', silent=False)

    graph = cdhit_output_to_graph(output_dir / 'cdhit_output.clstr')
    similar = set(graph.keys())
    for vals in graph.values():
        similar.update(vals)
    out_types = output_dir / (
        expand_path(args.train_types).with_suffix('').name
        + '_unbiased.types')
    decontaminate_types(args.train_types, similar, out_types)
    LOG.info(f'Decontaminated types written to {out_types}')


if __name__ == '__main__':
    main()
