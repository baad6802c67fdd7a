"""Training CLI (counterpart of ``pointvs_tpu/main.py``).

Usage:
    python -m pointvs_tpu_torch.main <model> <save_path> \\
        --train_data_root_pose <root> --train_types_pose <types> \\
        [--test_data_root_pose <root> --test_types_pose <types>] \\
        -ep 1 --layers 3 [--device cpu] [... every flag of the reference]

Models: ``egnn``, ``multitask``, ``lucid``, ``en_transformer`` (alias
``lie_transformer``), ``siamese`` (receptor and ligand towers over
entity-filtered batch pairs) and ``dense_egnn`` (alias ``lie_conv``, over
zero-padded point clouds); the model's input kind picks the loaders'
layout. ``--include_strain_info`` reads the types files' dE and strain
RMSD columns, and the EGNN head takes dE. ``--model_task both``
(multitask only) trains the pose phase and then the affinity phase, each
followed by its validation. ``--bf16`` runs the EGNN families' feature
MLPs in bfloat16 (other families have no such field and ignore it, as in
the reference); ``--double`` trains in float64 on the CPU only
(``--device cpu``; on the card it exits before any CUDA work, as the
reference's ``main`` refuses any backend but the CPU); ``--synthpharm``
reads the data with ``SynthPharmDataset``. ``--synth_pharm`` / ``-p`` is
recorded in ``cmd_args.yaml`` and drives nothing, as in the reference.
``--device_cache auto|on|off`` is the reference's device-resident dataset
(``training/engine.py``): ``on`` stops with a ``ValueError`` where the
reference's does (the pair and dense layouts, ``--p_remove_entity``,
``--p_noise``).

Writes the reference's run directory: ``cmd_args.yaml`` (with
``hostname`` and ``slurm_jobid``), ``model_kwargs.yaml``, ``output.log``,
``metrics.jsonl``, ``checkpoints/<task>_ckpt_epoch_<n>.pt``,
``<task>_predictions*.txt`` and, with ``--end_flag``, ``_FINISHED``. Runs
on the GPU unless ``--device cpu`` is given. ``--scatter_cap`` (the
reference's window capacity for its TPU segment kernels) is accepted and
has no effect: the port's segment kernels have no windows, so no batch
can overflow one (``note_scatter_cap`` logs this once).

Scale-out (``parallel/launch.py``): ``--num_devices D`` (default: the
visible cards, 1 on the CPU) trains on D ranks, one process each,
spawned here; ``--multihost`` makes this process one rank of a
launcher's job; ``--graph_shard G`` splits each dp row's edges over G
ranks (D / G dp rows; the egnn, lucid, en_transformer and multitask
models). Each rank builds its own loaders (its stripe of every epoch,
``batch_size / (D / G)`` graphs a step) and Trainer; rank 0 writes the
run directory, which equals a one-device run's. Spawned, ``main``
returns the ranks' reports (``launch.rank_report``), not a Trainer.
The reference's checks stop the CLI first: the batch size divisible by
the dp rows, ``--num_devices`` by ``--graph_shard``, ``--multihost``
with ``--node_bucket`` and ``--edge_bucket``.
"""
from __future__ import annotations

import os
import socket
from pathlib import Path

import torch

from pointvs_tpu_torch.config import model_kwargs_from_args, parse_args, \
    regression_task_of
from pointvs_tpu_torch.data.dataset import PointCloudDataset, \
    SynthPharmDataset
from pointvs_tpu_torch.data.loader import get_data_loader
from pointvs_tpu_torch.device import refuse_double_on_cuda, resolve_device
from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.models.registry import MODEL_REGISTRY, \
    model_input_kind
from pointvs_tpu_torch.parallel.launch import default_num_devices, \
    launcher_env, run_multihost, spawn
from pointvs_tpu_torch.parallel.mesh import Mesh
from pointvs_tpu_torch.training.engine import Trainer
from pointvs_tpu_torch.utils import load_yaml, mkdir, save_yaml

GRAPH_SHARD_MODELS = ('egnn', 'lucid', 'en_transformer', 'multitask')


def note_scatter_cap(args) -> None:
    """Log that a ``--scatter_cap`` given on the command line or in a
    run's ``cmd_args.yaml`` has no effect."""
    cap = getattr(args, 'scatter_cap', None)
    if cap is not None:
        get_logger().info(
            f"--scatter_cap {cap} has no effect: it caps the TPU kernels' "
            f"window load, and the port's segment kernels have no windows")


def check_scale_out(args, world: int) -> None:
    """The reference's checks of a scale-out command line for ``world``
    ranks (``main`` checks ``--multihost``'s buckets first);
    ``SystemExit`` naming the flags."""
    graph_shard = max(1, args.graph_shard)
    if world % graph_shard:
        raise SystemExit(f'--num_devices {world} must be divisible by '
                         f'--graph_shard {graph_shard}')
    if graph_shard > 1 and args.model not in GRAPH_SHARD_MODELS:
        raise SystemExit(f'--graph_shard supports the '
                         f'{", ".join(GRAPH_SHARD_MODELS)} models')
    if args.batch_size % (world // graph_shard):
        raise SystemExit(f'--batch_size {args.batch_size} must be divisible '
                         f'by the {world // graph_shard} data-parallel '
                         f'rows (--num_devices / --graph_shard)')


def build_loaders(args, mesh: Mesh = None):
    """(train_pose, train_affinity, test_pose, test_affinity,
    regression_task) from the flags, as the reference builds them; on a
    ``mesh``, this rank's loaders."""
    regression_task = regression_task_of(args)
    mesh = mesh or Mesh()
    dl_kwargs = dict(
        batch_size=args.batch_size // mesh.n_dp,
        shard_index=mesh.dp_rank, num_shards=mesh.n_dp,
        graph_shard=mesh.n_gp, gp_index=mesh.gp_rank, compact=args.compact,
        radius=args.radius, use_atomic_numbers=args.use_atomic_numbers,
        rot=False, polar_hydrogens=args.hydrogens,
        fname_suffix=args.input_suffix, edge_radius=args.edge_radius,
        estimate_bonds=args.estimate_bonds, prune=args.prune,
        extended_atom_types=args.extended_atom_types,
        include_strain_info=args.include_strain_info,
        layout=model_input_kind(args.model),
        dataset_class=(SynthPharmDataset if args.synthpharm
                       else PointCloudDataset),
        prefetch=args.prefetch, seed=args.seed, cache_dir=args.cache_dir)
    if args.node_bucket:
        dl_kwargs['node_buckets'] = (args.node_bucket,)
    if args.edge_bucket:
        dl_kwargs['edge_buckets'] = (args.edge_bucket,)
    train_kwargs = dict(mode='train', augmented_actives=args.augmented_actives,
                        min_aug_angle=args.min_aug_angle,
                        p_noise=args.p_noise,
                        p_remove_entity=args.p_remove_entity, **dl_kwargs)
    train_pose = train_affinity = test_pose = test_affinity = None
    if args.model_task != 'regression' and args.train_types_pose:
        train_pose = get_data_loader(
            args.train_data_root_pose, args.train_types_pose,
            max_active_rms_distance=args.max_active_rmsd,
            min_inactive_rms_distance=args.min_inactive_rmsd,
            max_inactive_rms_distance=args.max_inactive_rmsd,
            model_task='classification', **train_kwargs)
    if args.model_task in ('both', 'regression', 'multi_regression') \
            and args.train_types_affinity:
        train_affinity = get_data_loader(
            args.train_data_root_affinity, args.train_types_affinity,
            model_task=regression_task, **train_kwargs)
    if 'regression' not in args.model_task and args.test_data_root_pose:
        test_pose = get_data_loader(
            args.test_data_root_pose, args.test_types_pose, mode='val',
            model_task='classification', **dl_kwargs)
    if args.model_task != 'classification' and args.test_data_root_affinity:
        test_affinity = get_data_loader(
            args.test_data_root_affinity, args.test_types_affinity,
            mode='val', model_task=regression_task, **dl_kwargs)
    return train_pose, train_affinity, test_pose, test_affinity, \
        regression_task


def run_phases(trainer, args, loaders) -> None:
    """The pose phase and its validation, then the affinity phase and its
    validation; each training phase continues from the trainer's epoch."""
    train_pose, train_affinity, test_pose, test_affinity, regression_task \
        = loaders
    top1 = getattr(args, 'top1', False)
    val_on_epoch_end = getattr(args, 'val_on_epoch_end', False)
    for task, train, test, epochs in (
            ('classification', train_pose, test_pose,
             getattr(args, 'epochs_pose', 0)),
            (regression_task, train_affinity, test_affinity,
             getattr(args, 'epochs_affinity', 0))):
        if train is None and test is None:
            continue
        trainer.set_task(task)
        if epochs and train is not None and trainer.epoch < epochs:
            trainer.train_model(
                train, epochs=epochs, top1_on_end=top1,
                epoch_end_validation_set=test if val_on_epoch_end else None)
        if test is not None:
            trainer.val(test, top1_on_end=top1)
    if getattr(args, 'end_flag', False):
        (trainer.save_path / '_FINISHED').write_text('')


def _train_rank(device, args, save_path):
    """The CLI's work on one rank (or the one device); returns its
    Trainer."""
    mesh = Mesh(args.graph_shard)
    log = (get_logger(log_path=save_path) if mesh.chief
           else get_logger(level='WARNING'))
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    loaders = build_loaders(args, mesh)
    datasets = [dl.dataset for dl in loaders[:4] if dl is not None]
    if not datasets:
        raise SystemExit('No datasets specified — nothing to do.')
    model_kwargs = model_kwargs_from_args(args, datasets[0].feature_dim)
    if args.model_task == 'both':
        model_kwargs['model_task'] = 'classification'
    trainer = Trainer(
        args.model, save_path, device, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, optimiser=args.optimiser,
        use_1cycle=args.use_1cycle, warm_restarts=args.warm_restarts,
        only_save_best_models=args.only_save_best_models,
        regression_loss=args.regression_loss, seed=args.seed,
        wandb_project=args.wandb_project, wandb_run=args.wandb_run,
        wandb_dir=args.wandb_dir, profile=args.profile,
        num_devices=mesh.world, double=args.double,
        device_cache=args.device_cache, mesh=mesh, **model_kwargs)
    if args.load_weights is not None:
        trainer.load_weights(args.load_weights)
    if args.import_torch_weights:
        trainer.import_torch_weights(args.import_torch_weights)
    run_phases(trainer, args, loaders)
    log.info('Done.')
    return trainer


def main(argv=None):
    """Run the CLI; returns the Trainer (spawned ranks: their reports)."""
    args = parse_args(argv)
    if args.load_args is not None:
        for key, value in load_yaml(args.load_args).items():
            if hasattr(args, key):
                setattr(args, key, value)
    note_scatter_cap(args)
    if args.model not in MODEL_REGISTRY:
        raise SystemExit(f'model must be one of {sorted(MODEL_REGISTRY)}, '
                         f'got {args.model!r}')
    if args.model_task == 'both' and args.model != 'multitask':
        raise RuntimeError(
            'Sequential pose -> affinity training is only compatible with '
            'the multitask architecture')
    for types_arg, root_arg in (
            ('train_types_pose', 'train_data_root_pose'),
            ('train_types_affinity', 'train_data_root_affinity'),
            ('test_types_pose', 'test_data_root_pose'),
            ('test_types_affinity', 'test_data_root_affinity')):
        if getattr(args, types_arg) and not getattr(args, root_arg):
            raise SystemExit(f'--{types_arg} requires --{root_arg} to be '
                             f'set')
    refuse_double_on_cuda(args.double, args.device)
    device = resolve_device(args.device)

    if args.wandb_project is None:
        save_path = Path(args.save_path).expanduser()
    elif args.wandb_run is None:
        raise SystemExit(
            'wandb_run must be specified if wandb_project is specified.')
    else:
        save_path = Path(args.save_path, args.wandb_project,
                         args.wandb_run).expanduser()
    if args.multihost:
        if not (args.node_bucket and args.edge_bucket):
            raise SystemExit('--multihost requires --node_bucket and '
                             '--edge_bucket: processes pad independently and '
                             'must agree on static shapes')
        info = launcher_env()
        world, chief = info.world, info.rank == 0
    else:
        world, chief = (args.num_devices
                        or default_num_devices(args.device)), True
    check_scale_out(args, world)
    save_path = mkdir(save_path)
    args.hostname = socket.gethostname()
    args.slurm_jobid = os.getenv('SLURM_JOBID')
    if chief:
        save_yaml(vars(args), save_path / 'cmd_args.yaml')
    if args.multihost:
        return run_multihost(_train_rank, args.device, args, save_path)
    if world > 1:
        return spawn(_train_rank, world, args.device, args, save_path)
    return _train_rank(device, args, save_path)


if __name__ == '__main__':
    main()
