"""Rebuild a Trainer from a run directory or a ``.pt`` checkpoint.

Counterpart of ``pointvs_tpu/models/load_model.py``: locate the latest
checkpoint, read the ``model_kwargs.yaml`` / ``cmd_args.yaml`` sidecars,
rebuild the model with the run's optimiser settings and load its weights,
optimiser state and epoch counters. Run directories written by the JAX
package hold orbax checkpoints, which the port cannot read.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

from pointvs_tpu_torch.utils import expand_path, find_latest_checkpoint, \
    load_yaml


def resolve_run(weights_path, model_task: str = '') -> Tuple[Path, Path]:
    """(checkpoint_path, run_root) from a run dir or a checkpoint file; in
    a run dir, the newest checkpoint whose name starts with ``model_task``
    (``pose`` or ``affinity``; empty: any)."""
    weights_path = expand_path(weights_path)
    ckpt = (weights_path if weights_path.is_file()
            else find_latest_checkpoint(weights_path, model_task))
    if ckpt.suffix not in ('.pt', '.pth'):
        raise NotImplementedError(
            f'{ckpt} is not a .pt checkpoint; orbax run directories of the '
            f'JAX package are not readable by the port (see ROADMAP.md, '
            f'Queue 1)')
    root = ckpt.parent
    if root.name == 'checkpoints':
        root = root.parent
    return ckpt, root


def _sidecar(path: Path) -> dict:
    """A run directory's yaml sidecar, empty when it has none."""
    return (load_yaml(path) or {}) if path.exists() else {}


def _task_prefix(task: str) -> str:
    """Checkpoint name prefix of a task."""
    return 'affinity' if 'regression' in task else 'pose'


def run_args(weights_path) -> dict:
    """The ``cmd_args.yaml`` of the run that holds ``weights_path`` (a run
    directory or a checkpoint file in one); empty when it has none."""
    weights_path = expand_path(weights_path)
    root = weights_path if weights_path.is_dir() else weights_path.parent
    if root.name == 'checkpoints':
        root = root.parent
    return _sidecar(root / 'cmd_args.yaml')


def load_model(weights_path, device, init_path: bool = False, mesh=None):
    """Returns (trainer, model_kwargs, cmd_args).

    ``init_path`` reopens the run directory for continued training: the
    trainer writes its sidecars and records there, and loads the newest
    checkpoint of the run's task; of a multitask run, the newest of either
    task (every checkpoint holds both epoch counters, so the newest names
    the phase to continue). Otherwise the trainer is silent and loads the
    newest checkpoint of any task, as the reference's ``load_model`` does:
    after a ``--model_task both`` run that is the affinity phase's, whose
    trunk serves both heads (the caller's task picks the head). A
    ``--double`` run loads as float64, on the CPU only.

    The Trainer keeps the run's ``--device_cache`` (``auto`` where the
    run has none), so serving through ``Trainer.val`` takes the
    device-resident dataset as the reference's does.

    ``mesh`` (``parallel/mesh.Mesh``) makes the Trainer one rank of a
    scale-out run (``--num_devices``); without it the Trainer has one
    device, whatever mesh the run was trained on.

    The Trainer takes the reference's default seed (2), not the run's
    ``--seed``: the reference's ``load_model`` passes none, so a resumed
    run's dropout keys restart from ``PRNGKey(2)`` at step 0 in both
    packages.
    """
    from pointvs_tpu_torch.training.engine import Trainer

    weights_path = expand_path(weights_path)
    prefix = ''
    if weights_path.is_dir() and init_path:
        saved_task = _sidecar(weights_path / 'model_kwargs.yaml').get(
            'model_task', 'classification')
        multitask = _sidecar(weights_path / 'cmd_args.yaml').get(
            'model') == 'multitask'
        if not multitask:
            prefix = _task_prefix(saved_task)
    ckpt, root = resolve_run(weights_path, prefix)
    model_kwargs = load_yaml(root / 'model_kwargs.yaml') or {}
    cmd_args = _sidecar(root / 'cmd_args.yaml')
    # Fixups for reference run dirs (ref load_model.py:49-57): the
    # node/edge attention back-compat keys, and the 'act' kwarg that the
    # reference never passed to its layers (SiLU is hard-coded there).
    if 'node_attention' not in cmd_args:
        cmd_args['node_attention'] = False
    if 'edge_attention' not in cmd_args:
        cmd_args['edge_attention'] = cmd_args.get('egnn_attention', False)
        model_kwargs['edge_attention'] = cmd_args['edge_attention']
    model_kwargs.pop('act', None)

    trainer = Trainer(
        cmd_args.get('model', 'egnn'), root, device,
        learning_rate=cmd_args.get('learning_rate', 1e-3),
        weight_decay=cmd_args.get('weight_decay', 1e-4),
        optimiser=cmd_args.get('optimiser', 'adam'),
        use_1cycle=cmd_args.get('use_1cycle', False),
        warm_restarts=cmd_args.get('warm_restarts', False),
        only_save_best_models=cmd_args.get('only_save_best_models', False),
        regression_loss=cmd_args.get('regression_loss', 'mse'),
        silent=not init_path,
        double=cmd_args.get('double', False),
        device_cache=cmd_args.get('device_cache', 'auto'), mesh=mesh,
        **model_kwargs)
    trainer.load_weights(ckpt)
    return trainer, model_kwargs, cmd_args
