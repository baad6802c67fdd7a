"""Resume a training run from its latest checkpoint (counterpart of
``pointvs_tpu/resume_training.py``).

Rebuilds the loaders from the run's ``cmd_args.yaml`` (the reference's
defaults for keys an older run did not write; the layout from the run's
model), restores the weights, the
optimiser state and the epoch counters, and continues the pose and then
the affinity phase from the saved epochs. A multitask ``--model_task
both`` run resumes from its newest checkpoint of either task, whose
counters name the phase to continue. ``--bf16``, ``--double`` (with
``--device cpu``) and ``--synthpharm`` runs resume as they were trained;
a run's ``--scatter_cap`` has no effect, as in ``main``.

``--num_devices`` resumes on that many ranks (``parallel/launch.py``); as
in the reference, the default is the run's own ``--num_devices``, else
the visible cards (1 on the CPU), and the run's ``--graph_shard`` holds.
A run trained on any number of ranks resumes on any other.

Usage: python -m pointvs_tpu_torch.resume_training <run_dir> \
    [--num_devices D] [--device cpu]
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

from pointvs_tpu_torch.device import refuse_double_on_cuda, resolve_device
from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.main import build_loaders, check_scale_out, \
    note_scatter_cap, run_phases
from pointvs_tpu_torch.models.load_model import load_model, run_args
from pointvs_tpu_torch.parallel.launch import default_num_devices, spawn
from pointvs_tpu_torch.parallel.mesh import Mesh

LOG = get_logger()
# Flags an older run's cmd_args.yaml may lack, with their defaults.
_DEFAULTS = (('prefetch', 2), ('seed', 2), ('cache_dir', None),
             ('p_noise', -1), ('p_remove_entity', 0), ('node_bucket', None),
             ('edge_bucket', None), ('include_strain_info', False),
             ('synthpharm', False), ('graph_shard', 1),
             ('model', 'egnn'), ('batch_size', 32))


def _with_defaults(cmd_args: dict) -> SimpleNamespace:
    """A run's cmd_args, with the defaults of keys it lacks."""
    saved = SimpleNamespace(**cmd_args)
    for attr, default in _DEFAULTS:
        if not hasattr(saved, attr):
            setattr(saved, attr, default)
    return saved


def _resume_rank(device, base_path):
    """The resume on one rank (or the one device); returns its Trainer."""
    mesh = Mesh(_with_defaults(run_args(base_path)).graph_shard)
    trainer, _, cmd_args = load_model(base_path, device, init_path=True,
                                      mesh=mesh)
    saved = _with_defaults(cmd_args)
    loaders = build_loaders(saved, mesh)
    LOG.info(f'Resuming from pose epoch {trainer.p_epoch}, affinity epoch '
             f'{trainer.a_epoch}')
    run_phases(trainer, saved, loaders)
    LOG.info('Resume complete.')
    return trainer


def main(argv=None):
    """Run the CLI; returns the Trainer (spawned ranks: their reports)."""
    parser = argparse.ArgumentParser()
    parser.add_argument('base_path', help='Run directory to resume')
    parser.add_argument('--num_devices', type=int, default=None)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = parser.parse_args(argv)
    saved = _with_defaults(run_args(args.base_path))
    note_scatter_cap(saved)
    refuse_double_on_cuda(getattr(saved, 'double', False), args.device)
    device = resolve_device(args.device)
    world = (args.num_devices or getattr(saved, 'num_devices', None)
             or default_num_devices(args.device))
    check_scale_out(saved, world)
    if world > 1:
        return spawn(_resume_rank, world, args.device, args.base_path)
    return _resume_rank(device, args.base_path)


if __name__ == '__main__':
    main()
