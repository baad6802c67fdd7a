"""Raw PDB/SDF inputs -> parquets -> predictions from a trained model
(counterpart of ``pointvs_tpu/scripts/for_steph.py``).

The input manifest has two columns (``receptor.pdb ligand.sdf``, relative
to ``--data_root``); the outputs are ``<out>/parquets/`` (each structure
typed by ``StructuralFileParser``), ``<out>/<manifest>.types`` and
``<out>/<task>_predictions.txt`` with the ``' | '`` separators removed.

Usage:
    python -m pointvs_tpu_torch.scripts.for_steph -i inputs.txt \
        -d <data_root> -m <run_dir> -o <output_dir> [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Union

import torch

from pointvs_tpu_torch.dataset_generation.types_to_parquet import (
    StructuralFileParser,
)
from pointvs_tpu_torch.device import refuse_double_on_cuda, resolve_device
from pointvs_tpu_torch.inference import get_model_and_test_dl
from pointvs_tpu_torch.models.load_model import run_args
from pointvs_tpu_torch.utils import expand_path, get_logger, mkdir

LOG = get_logger()
Fname = Union[str, Path]


def generate_types_file(input_fnames: Fname, types_fname: Fname) -> None:
    """Input manifest -> types file with parquet extensions."""
    out_lines = []
    with open(input_fnames, 'r', encoding='utf-8') as f:
        for line in f:
            chunks = line.split()
            if len(chunks) != 2:
                continue
            rec_pdb, lig_sdf = chunks
            rec_pq = rec_pdb.replace('.pdb', '.parquet')
            lig_pq = lig_sdf.replace('.sdf', '.mol2').replace(
                '.mol2', '.parquet')
            out_lines.append(f'{rec_pq} {lig_pq}')
    with open(expand_path(types_fname), 'w', encoding='utf-8') as f:
        f.write('\n'.join(out_lines) + ('\n' if out_lines else ''))


def predict_on_molecular_inputs(input_fnames: Path, data_root: Path,
                                model_path: Path, output_dir: Path,
                                device: torch.device | str = 'cuda') -> Path:
    """Convert raw inputs to parquets and run inference; returns the
    predictions path."""
    if not isinstance(device, torch.device):
        refuse_double_on_cuda(run_args(model_path).get('double', False),
                              device)
        device = resolve_device(device)
    output_parquets_dir = mkdir(output_dir / 'parquets')
    types_fname = output_dir / Path(input_fnames).with_suffix('.types').name
    preds_fname = output_dir / 'predictions.txt'

    LOG.info('Generating types file...')
    generate_types_file(input_fnames, types_fname)

    rec_pqs, lig_pqs, rec_pdbs, lig_sdfs = [], [], [], []
    with open(types_fname, 'r', encoding='utf-8') as f:
        for line in f:
            rec, lig = line.strip().split()
            rec_pqs.append(Path(output_parquets_dir, rec))
            lig_pqs.append(Path(output_parquets_dir, lig))
    with open(input_fnames, 'r', encoding='utf-8') as f:
        for line in f:
            chunks = line.split()
            if len(chunks) != 2:
                continue
            rec_pdbs.append(Path(data_root, chunks[0]))
            lig_sdfs.append(Path(data_root, chunks[1]))

    LOG.info('Converting inputs to parquet format...')
    trainer, dl = get_model_and_test_dl(
        expand_path(model_path), types_fname, output_parquets_dir, device,
        batch_size=1)
    extended = bool(getattr(dl.dataset, 'extended_atom_types', False))
    lig_parser = StructuralFileParser('ligand', extended)
    rec_parser = StructuralFileParser('receptor', extended)
    for lig_pq, lig_sdf in zip(lig_pqs, lig_sdfs):
        lig_parser.file_to_parquets(lig_sdf, lig_pq.parent, lig_pq.name,
                                    add_polar_hydrogens=False)
    for rec_pq, rec_pdb in zip(rec_pqs, rec_pdbs):
        rec_parser.file_to_parquets(rec_pdb, rec_pq.parent, rec_pq.name,
                                    add_polar_hydrogens=False)

    # Rebuild the loader now that parquets exist on disk.
    trainer, dl = get_model_and_test_dl(
        expand_path(model_path), types_fname, output_parquets_dir, device,
        batch_size=1)
    LOG.info('Performing inference...')
    trainer.val(dl, predictions_file=preds_fname)
    preds_fname = preds_fname.parent / (
        trainer.model_task_for_fnames + '_' + preds_fname.name)
    contents = preds_fname.read_text().replace(' | ', ' ')
    preds_fname.write_text(contents)
    LOG.info('Done!')
    return preds_fname


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser()
    ap.add_argument('--input_fnames', '-i', required=True,
                    help='Two-column file: receptor.pdb ligand.sdf paths')
    ap.add_argument('--data_root', '-d', default='.',
                    help='Root relative to which input paths are given')
    ap.add_argument('--model', '-m', required=True,
                    help='Model run directory or checkpoint')
    ap.add_argument('--output_dir', '-o', required=True)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)
    return predict_on_molecular_inputs(
        expand_path(args.input_fnames), expand_path(args.data_root),
        expand_path(args.model), mkdir(args.output_dir), args.device)


if __name__ == '__main__':
    main()
