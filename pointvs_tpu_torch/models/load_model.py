"""Rebuild a scoring Trainer from a run directory or a ``.pt`` checkpoint.

Counterpart of ``pointvs_tpu/models/load_model.py``: locate the latest
checkpoint, read the ``model_kwargs.yaml`` / ``cmd_args.yaml`` sidecars,
rebuild the model and load its weights. Run directories written by the JAX
package hold orbax checkpoints, which the port cannot read yet.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

from pointvs_tpu_torch.utils import expand_path, find_latest_checkpoint, \
    load_yaml


def resolve_run(weights_path) -> Tuple[Path, Path]:
    """(checkpoint_path, run_root) from a run dir or a checkpoint file."""
    weights_path = expand_path(weights_path)
    ckpt = (weights_path if weights_path.is_file()
            else find_latest_checkpoint(weights_path))
    if ckpt.suffix not in ('.pt', '.pth'):
        raise NotImplementedError(
            f'{ckpt} is not a .pt checkpoint; orbax run directories of the '
            f'JAX package are not readable by the port yet (checkpoints: '
            f'see ROADMAP.md, Queue 1)')
    root = ckpt.parent
    if root.name == 'checkpoints':
        root = root.parent
    return ckpt, root


def load_model(weights_path, device):
    """Returns (trainer, model_kwargs, cmd_args)."""
    from pointvs_tpu_torch.training.engine import Trainer

    ckpt, root = resolve_run(weights_path)
    model_kwargs = load_yaml(root / 'model_kwargs.yaml') or {}
    cmd_args_path = root / 'cmd_args.yaml'
    cmd_args = load_yaml(cmd_args_path) if cmd_args_path.exists() else {}
    if cmd_args.get('double', False):
        raise NotImplementedError('--double (float64) runs are not in the '
                                  'port yet (see ROADMAP.md, Queue 1)')
    # Fixups for reference run dirs (ref load_model.py:49-57): the
    # node/edge attention back-compat keys, and the 'act' kwarg that the
    # reference never passed to its layers (SiLU is hard-coded there).
    if 'node_attention' not in cmd_args:
        cmd_args['node_attention'] = False
    if 'edge_attention' not in cmd_args:
        cmd_args['edge_attention'] = cmd_args.get('egnn_attention', False)
        model_kwargs['edge_attention'] = cmd_args['edge_attention']
    model_kwargs.pop('act', None)

    trainer = Trainer(cmd_args.get('model', 'egnn'), root, device,
                      **model_kwargs)
    trainer.load_weights(ckpt)
    return trainer, model_kwargs, cmd_args
