"""Score a test set with a saved model (counterpart of
``pointvs_tpu/inference.py``).

Rebuilds the model from a run directory (``.pt`` checkpoint plus
``model_kwargs.yaml`` / ``cmd_args.yaml`` sidecars), rebuilds the data
pipeline from the saved flags (the layout the model's input kind names:
graph, receptor/ligand pair or dense; parquet, PDB, SDF or MOL2
structures by each path's suffix), scores every pose and writes
``<task>_<output_fname>`` into the run directory. As in the reference's
serving CLI (ROADMAP.md, Queue 3): a run trained with
``--include_strain_info`` is scored with dE = 0 (the loader is built
without the flag), and a ``--synthpharm`` run is refused with a
``ValueError`` naming the flag (the reference reads it as ordinary
complexes, whose columns a synthetic-pharmacophore file lacks, and stops
at its first item). A ``--double``
run is served in float64 with ``--device cpu`` only; on the card the CLI
exits before any CUDA work. The newest checkpoint of the run serves, of
either task for a multitask run, as in the reference; ``--model_task``
picks the task, and with it a multitask model's head (``both`` serves as
``classification``). Runs on the GPU unless ``--device cpu`` is given.
``--num_devices`` is the reference's flag (``_auto_num_devices``: the
largest count up to it, or up to the visible cards, that divides the
batch size): more than 1 spawns that many ranks (``parallel/launch.py``),
each scoring its stripe of the test set, and rank 0 writes the file one
device writes. A run trained edge-sharded serves on one device. Under the
run's ``--device_cache`` (``auto`` where the run has none) the test set
goes to the device once and ``Trainer.val`` collates each batch there
(``data/device_dataset.py``), as the reference's serving CLI does.

Usage:
    python -m pointvs_tpu_torch.inference <run_dir_or_ckpt> <test_types> \
        <data_root> [--model_task t] [--batch_size N] [--output_fname f] \
        [--num_devices D] [--top1] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from pointvs_tpu_torch.data.loader import get_data_loader
from pointvs_tpu_torch.device import refuse_double_on_cuda, resolve_device
from pointvs_tpu_torch.models.load_model import load_model, run_args
from pointvs_tpu_torch.parallel.launch import default_num_devices, spawn
from pointvs_tpu_torch.parallel.mesh import Mesh
from pointvs_tpu_torch.utils import get_logger

LOG = get_logger()


def _auto_num_devices(batch_size: int, device_name: str,
                      requested=None) -> int:
    """Largest rank count up to ``requested`` (or the visible cards) that
    divides the batch size (the reference's ``_auto_num_devices``)."""
    available = requested or default_num_devices(device_name)
    for d in range(min(available, batch_size), 0, -1):
        if batch_size % d == 0:
            return d
    return 1


def get_model_and_test_dl(model_path, test_types, data_root, device,
                          model_task=None, batch_size=None, mesh=None):
    """(trainer, loader) rebuilt from a run directory; on a ``mesh``, this
    rank's."""
    if run_args(model_path).get('synthpharm'):
        raise ValueError(
            '--synthpharm: the serving CLI reads a run\'s structures as '
            'ordinary complexes, as the reference\'s does, and a '
            'synthetic-pharmacophore file has no atomic_number or types '
            'column (see ROADMAP.md, Queue 3)')
    trainer, model_kwargs, cmd_args = load_model(model_path, device,
                                                 mesh=mesh)
    model_task = model_task or model_kwargs.get('model_task',
                                                'classification')
    if model_task == 'both':
        model_task = 'classification'
    trainer.set_task(model_task)
    mesh = trainer.mesh
    loader = get_data_loader(
        data_root, test_types, rot=False,
        batch_size=(batch_size or cmd_args.get('batch_size', 32))
        // mesh.n_dp, shard_index=mesh.dp_rank, num_shards=mesh.n_dp,
        compact=cmd_args.get('compact', True),
        radius=cmd_args.get('radius', 10),
        use_atomic_numbers=cmd_args.get('use_atomic_numbers', False),
        polar_hydrogens=cmd_args.get('hydrogens', False),
        edge_radius=cmd_args.get('edge_radius', 4.0),
        estimate_bonds=cmd_args.get('estimate_bonds', False),
        prune=cmd_args.get('prune', False),
        extended_atom_types=cmd_args.get('extended_atom_types', False),
        fname_suffix=cmd_args.get('input_suffix', 'parquet'),
        layout=trainer.input_kind, model_task=model_task, mode='val')
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
    saved = run_args(args.model_path)
    refuse_double_on_cuda(saved.get('double', False), args.device)
    device = resolve_device(args.device)
    args.batch_size = args.batch_size or saved.get('batch_size', 32)
    world = _auto_num_devices(args.batch_size, args.device,
                              args.num_devices)
    if world > 1:
        return spawn(_serve_rank, world, args.device, args)
    return _serve_rank(device, args)


def _serve_rank(device, args):
    """Score the test set on one rank (or the one device); returns its
    Trainer."""
    trainer, loader = get_model_and_test_dl(
        args.model_path, args.test_types, args.data_root, device,
        model_task=args.model_task, batch_size=args.batch_size, mesh=Mesh())
    out = trainer.save_path / args.output_fname
    trainer.val(loader, predictions_file=out, top1_on_end=args.top1)
    LOG.info(f'Predictions written beside {out}')
    return trainer


if __name__ == '__main__':
    main()
