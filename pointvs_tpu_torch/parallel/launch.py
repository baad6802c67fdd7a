"""Starting the ranks of a run over ``torch.distributed``.

The reference runs one process per host that drives a JAX device mesh
(``jax.distributed.initialize()`` under ``--multihost``); the port runs
one process per rank, PyTorch's idiom, and each rank computes what the
reference's device of the same mesh position computes:

- ``--num_devices D`` (``spawn``): the CLI starts D local ranks with
  ``torch.multiprocessing``'s ``spawn`` start method, on a free localhost
  port. Rank r runs on ``cuda:(r % torch.cuda.device_count())``, or on
  the CPU under ``--device cpu``. The parent joins its children; a rank
  that raises stops the others, and the parent raises.
- ``--multihost`` (``run_multihost``): this process is one rank of a job
  whose launcher (``torchrun``, or a scheduler doing the same) set
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT``.
- Without either, ``default_num_devices`` is the number of visible cards
  (the reference's ``len(jax.devices())``), 1 on the CPU. Ranks on the
  CPU split the host's threads between them.

The backend rule (``backend_for``), logged once by rank 0 and never
switched after a failure: NCCL when every rank has a card of its own,
gloo on the CPU and when ranks share a card. A failed initialisation or
collective raises.

Each spawned rank sends its parent a report (``rank_report`` of its
Trainer, unless the caller names another function): its backend and
device, per-step losses, step and all-reduce times, epoch wall times,
validation scores and kernel launch counts.
"""
from __future__ import annotations

import os
import pickle
import socket
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist

from pointvs_tpu_torch.device import resolve_device
from pointvs_tpu_torch.logging import get_logger

LOG = get_logger()


def default_num_devices(device_name: str) -> int:
    """The visible cards under ``cuda``, 1 on the CPU."""
    if torch.device(device_name).type == 'cuda':
        return max(1, torch.cuda.device_count())
    return 1


def backend_for(device_type: str, local_world: int) -> str:
    """NCCL when every local rank has a card of its own, else gloo."""
    if device_type == 'cuda' and local_world <= torch.cuda.device_count():
        return 'nccl'
    return 'gloo'


@dataclass
class RankInfo:
    rank: int
    world: int
    local_rank: int
    local_world: int
    init_method: str


def launcher_env() -> RankInfo:
    """This process's rank from the launcher's environment (``--multihost``,
    the counterpart of ``jax.distributed.initialize()``)."""
    missing = [k for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                           'MASTER_PORT') if k not in os.environ]
    if missing:
        raise SystemExit(f'--multihost reads the launcher environment '
                         f'(as torchrun sets it); {missing} not set')
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    return RankInfo(
        rank, world, int(os.environ.get('LOCAL_RANK', rank)),
        int(os.environ.get('LOCAL_WORLD_SIZE', world)),
        f'tcp://{os.environ["MASTER_ADDR"]}:{os.environ["MASTER_PORT"]}')


def init_rank(info: RankInfo, device_name: str) -> torch.device:
    """Join the process group; returns this rank's device (with the
    port's full-f32 matmul settings, ``device.resolve_device``)."""
    device = resolve_device(device_name)
    if device.type == 'cuda':
        device = torch.device('cuda', info.local_rank
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:   # the host's ranks share its cores
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // info.local_world))
    backend = backend_for(device.type, info.local_world)
    dist.init_process_group(backend, init_method=info.init_method,
                            world_size=info.world, rank=info.rank)
    if info.rank == 0:
        why = ('every rank has a card of its own' if backend == 'nccl'
               else 'ranks on the CPU' if device.type == 'cpu'
               else f'{info.local_world} local ranks share '
                    f'{torch.cuda.device_count()} card(s)')
        LOG.info(f'torch.distributed: {info.world} rank(s) over {backend} '
                 f'({why})')
    else:
        LOG.setLevel('WARNING')
    return device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def rank_report(trainer) -> dict:
    """What a spawned rank sends its parent."""
    from pointvs_tpu_torch.ops.segment_kernels import launch_counts
    return {'rank': trainer.mesh.rank, 'backend': trainer.mesh.backend,
            'device': str(trainer.device),
            'train_losses': list(trainer.train_losses),
            'step_ms': trainer.step_ms(),
            'allreduce_ms': trainer.allreduce_ms(),
            'epoch_seconds': list(trainer.epoch_seconds),
            'val_scores': trainer.val_scores,
            'launch_counts': launch_counts()}


def _spawned(rank: int, world: int, init_method: str, device_name: str,
             target, args: tuple, report_dir: str, report) -> None:
    device = init_rank(RankInfo(rank, world, rank, world, init_method),
                       device_name)
    try:
        report = report(target(device, *args))
        # Written to a file: a pipe would block a rank whose report
        # outgrows its buffer until the parent reads it.
        with open(Path(report_dir) / f'rank{rank}.pkl', 'wb') as f:
            pickle.dump(report, f)
    finally:
        dist.destroy_process_group()


def spawn(target, nprocs: int, device_name: str, *args,
          report=rank_report) -> list:
    """Run ``target(device, *args)`` (a module-level function) on
    ``nprocs`` local ranks; returns ``report`` of each rank's result (a
    module-level function; by default ``rank_report`` of a Trainer), in
    rank order."""
    import torch.multiprocessing as mp
    init_method = f'tcp://127.0.0.1:{free_port()}'
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_spawned, nprocs=nprocs, join=True,
                 args=(nprocs, init_method, device_name, target, args, tmp,
                       report))
        reports = []
        for rank in range(nprocs):
            with open(Path(tmp) / f'rank{rank}.pkl', 'rb') as f:
                reports.append(pickle.load(f))
    return reports


def run_multihost(target, device_name: str, *args):
    """Run ``target(device, *args)`` as the rank the launcher's
    environment names; returns what it returns."""
    device = init_rank(launcher_env(), device_name)
    try:
        return target(device, *args)
    finally:
        dist.destroy_process_group()
