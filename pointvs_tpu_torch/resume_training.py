"""Resume a training run from its latest checkpoint (counterpart of
``pointvs_tpu/resume_training.py``).

Rebuilds the loaders from the run's ``cmd_args.yaml`` (the reference's
defaults for keys an older run did not write; the layout from the run's
model), restores the weights, the
optimiser state and the epoch counters, and continues the pose and then
the affinity phase from the saved epochs. A multitask ``--model_task
both`` run resumes from its newest checkpoint of either task, whose
counters name the phase to continue. ``--bf16``, ``--double`` (with
``--device cpu``) and ``--synthpharm`` runs resume as they were trained.

Usage: python -m pointvs_tpu_torch.resume_training <run_dir> [--device cpu]
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

from pointvs_tpu_torch.device import refuse_double_on_cuda, resolve_device
from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.main import build_loaders, run_phases
from pointvs_tpu_torch.models.load_model import load_model, run_args

LOG = get_logger()
# Flags an older run's cmd_args.yaml may lack, with their defaults.
_DEFAULTS = (('prefetch', 2), ('seed', 2), ('cache_dir', None),
             ('p_noise', -1), ('p_remove_entity', 0), ('node_bucket', None),
             ('edge_bucket', None), ('include_strain_info', False),
             ('synthpharm', False))


def main(argv=None):
    """Run the CLI; returns the Trainer."""
    parser = argparse.ArgumentParser()
    parser.add_argument('base_path', help='Run directory to resume')
    parser.add_argument('--num_devices', type=int, default=None)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = parser.parse_args(argv)
    if args.num_devices not in (None, 1):
        raise NotImplementedError(
            f'--num_devices {args.num_devices}: data parallelism is not in '
            f'the port (see ROADMAP.md, Queue 1)')
    refuse_double_on_cuda(run_args(args.base_path).get('double', False),
                          args.device)
    trainer, _, cmd_args = load_model(args.base_path,
                                      resolve_device(args.device),
                                      init_path=True)
    saved = SimpleNamespace(**cmd_args)
    for attr, default in _DEFAULTS:
        if not hasattr(saved, attr):
            setattr(saved, attr, default)
    loaders = build_loaders(saved)
    LOG.info(f'Resuming from pose epoch {trainer.p_epoch}, affinity epoch '
             f'{trainer.a_epoch}')
    run_phases(trainer, saved, loaders)
    LOG.info('Resume complete.')
    return trainer


if __name__ == '__main__':
    main()
