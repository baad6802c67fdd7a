"""Checkpoints in the reference's ``.pt`` layout.

Counterpart of ``pointvs_tpu/training/checkpoints.py``, which writes orbax
directories; the port writes the layout of the original PointVS instead
(``<save_path>/checkpoints/<task>_ckpt_epoch_<n>.pt`` holding
``model_state_dict``, ``optimiser_state_dict``, ``p_epoch``, ``a_epoch``,
``learning_rate`` and ``weight_decay``). The model state_dict is in the
reference key schema, so ``models/params.load_reference_checkpoint`` and
the JAX package's ``models/torch_import.load_torch_checkpoint`` both read
it back.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from pointvs_tpu_torch.utils import expand_path, mkdir


def checkpoint_path(save_path, task_for_fnames: str, epoch: int) -> Path:
    return (expand_path(save_path) / 'checkpoints'
            / f'{task_for_fnames}_ckpt_epoch_{epoch}.pt')


def save_checkpoint(path, model: torch.nn.Module,
                    optimiser: Optional[torch.optim.Optimizer],
                    p_epoch: int, a_epoch: int, lr: float,
                    weight_decay: Optional[float]) -> Path:
    """Write one checkpoint file (overwrites an existing one)."""
    path = expand_path(path)
    mkdir(path.parent)
    state = {
        'model_state_dict': {k: v.detach().cpu()
                             for k, v in model.state_dict().items()},
        'p_epoch': int(p_epoch),
        'a_epoch': int(a_epoch),
        'learning_rate': float(lr),
        'weight_decay': float(weight_decay or 0.0),
    }
    if optimiser is not None:
        state['optimiser_state_dict'] = optimiser.state_dict()
    tmp = path.with_suffix('.pt.tmp')
    torch.save(state, tmp)
    tmp.replace(path)
    return path
