"""Score a test set with a saved model (counterpart of
``pointvs_tpu/inference.py``).

Rebuilds the model from a run directory (``.pt`` checkpoint plus
``model_kwargs.yaml`` / ``cmd_args.yaml`` sidecars), rebuilds the data
pipeline from the saved flags, scores every pose and writes
``<task>_<output_fname>`` into the run directory. Runs on the GPU unless
``--device cpu`` is given. ``--num_devices`` is the reference's flag: None
or 1 runs on the one device; more is refused until data parallelism is
ported.

Usage:
    python -m pointvs_tpu_torch.inference <run_dir_or_ckpt> <test_types> \
        <data_root> [--model_task t] [--batch_size N] [--output_fname f] \
        [--num_devices 1] [--top1] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from pointvs_tpu_torch.data.loader import get_data_loader
from pointvs_tpu_torch.device import resolve_device
from pointvs_tpu_torch.models.load_model import load_model
from pointvs_tpu_torch.utils import get_logger

LOG = get_logger()


def get_model_and_test_dl(model_path, test_types, data_root, device,
                          model_task=None, batch_size=None):
    """(trainer, loader) rebuilt from a run directory."""
    trainer, model_kwargs, cmd_args = load_model(model_path, device)
    model_task = model_task or model_kwargs.get('model_task',
                                                'classification')
    if model_task == 'both':
        model_task = 'classification'
    trainer.set_task(model_task)
    loader = get_data_loader(
        data_root, test_types,
        batch_size=batch_size or cmd_args.get('batch_size', 32),
        compact=cmd_args.get('compact', True),
        radius=cmd_args.get('radius', 10),
        use_atomic_numbers=cmd_args.get('use_atomic_numbers', False),
        polar_hydrogens=cmd_args.get('hydrogens', False),
        edge_radius=cmd_args.get('edge_radius', 4.0),
        estimate_bonds=cmd_args.get('estimate_bonds', False),
        prune=cmd_args.get('prune', False),
        extended_atom_types=cmd_args.get('extended_atom_types', False),
        model_task=model_task, mode='val')
    return trainer, loader


def main(argv=None):
    """Run the CLI; returns the Trainer (its ``val_scores`` hold the raw
    scores of the rows written)."""
    parser = argparse.ArgumentParser()
    parser.add_argument('model_path', help='Run directory or checkpoint')
    parser.add_argument('test_types', help='Types file for the test set')
    parser.add_argument('data_root', help='Root for parquet paths')
    parser.add_argument('--model_task', default=None)
    parser.add_argument('--batch_size', type=int, default=None)
    parser.add_argument('--output_fname', default='predictions.txt')
    parser.add_argument('--num_devices', type=int, default=None)
    parser.add_argument('--top1', action='store_true')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = parser.parse_args(argv)
    if args.num_devices not in (None, 1):
        raise NotImplementedError(
            f'--num_devices {args.num_devices}: data parallelism is not in '
            f'the port yet (see ROADMAP.md, Queue 1, item 5)')

    device = resolve_device(args.device)
    trainer, loader = get_model_and_test_dl(
        args.model_path, args.test_types, args.data_root, device,
        model_task=args.model_task, batch_size=args.batch_size)
    out = trainer.save_path / args.output_fname
    trainer.val(loader, predictions_file=out, top1_on_end=args.top1)
    LOG.info(f'Predictions written beside {out}')
    return trainer


if __name__ == '__main__':
    main()
