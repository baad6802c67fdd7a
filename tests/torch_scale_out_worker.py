"""Ranks of the port's scale-out tests (``test_torch_scale_out.py``).

``run_ranks`` starts a gloo group of CPU processes (``torch.multiprocessing``
spawn, a free localhost port) and runs a list of cases on every rank; each
case builds the ``Mesh`` it names, computes on this rank's piece of the
inputs and returns numpy results, which come back to the test in rank
order. This module imports no JAX: the ranks are fresh processes that need
only torch and the port.
"""
from __future__ import annotations

import pickle
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pointvs_tpu_torch.data.buckets import GraphBatch, to_device
from pointvs_tpu_torch.models.registry import build_model
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.parallel.graph_shard import make_sharded_forward, \
    make_sharded_train_step, make_train_step_2d
from pointvs_tpu_torch.parallel.launch import free_port
from pointvs_tpu_torch.parallel.mesh import Mesh
from pointvs_tpu_torch.training.optimisers import build_optimiser

AGG_OPS = {
    'sum_to_src': lambda a, x: a.sum_to_src(x['feat']),
    'mean_to_src': lambda a, x: a.mean_to_src(x['feat']),
    'softmax_src': lambda a, x: a.softmax_src(x['logits']),
    'fused_sum_mean_to_src': lambda a, x: a.fused_sum_mean_to_src(
        x['feat'], x['trans']),
    'fused_softmax_aggregate': lambda a, x: a.fused_softmax_aggregate(
        x['feat'], x['logits'], x['trans']),
    'fused_sigmoid_aggregate': lambda a, x: a.fused_sigmoid_aggregate(
        x['feat'], x['logits'], x['trans']),
    'sum_to_dst': lambda a, x: a.sum_to_dst(x['feat']),
    'mean_to_dst': lambda a, x: a.mean_to_dst(x['feat']),
}
EDGE_INPUTS = ('feat', 'logits', 'trans')


def _batch(fields: dict) -> GraphBatch:
    return to_device(GraphBatch(**fields), torch.device('cpu'))


def _aggregate(mesh: Mesh, p: dict) -> dict:
    """Every op of ``AGG_OPS`` on this rank's edge shard: (outputs,
    gradients of sum(output * cotangent) by the shard's edge inputs)."""
    shard = p['shards'][mesh.gp_rank]
    out = {}
    for op, fn in AGG_OPS.items():
        agg = EdgeAggregator(
            torch.from_numpy(shard['senders']),
            torch.from_numpy(shard['receivers']),
            torch.from_numpy(shard['edge_mask']), p['num_nodes'],
            recv_perm=torch.from_numpy(shard['recv_perm']),
            axis=mesh.edge_axis)
        x = {k: torch.tensor(shard[k], requires_grad=True)
             for k in EDGE_INPUTS}
        res = fn(agg, x)
        res = res if isinstance(res, tuple) else (res,)
        loss = sum((r * torch.from_numpy(c)).sum()
                   for r, c in zip(res, p['cotangents'][op]))
        grads = torch.autograd.grad(loss, [x[k] for k in EDGE_INPUTS],
                                    allow_unused=True)
        out[op] = ([r.detach().numpy() for r in res],
                   [None if g is None else g.numpy() for g in grads])
    return out


def _model(mesh: Mesh, p: dict):
    kwargs = dict(p['kwargs'], edge_shard_axis=mesh.edge_axis)
    if kwargs.get('graphnorm_whole_batch'):
        kwargs['batch_shard_axis'] = mesh.batch_axis
    model = build_model(p['name'], **kwargs)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in p['state_dict'].items()}, strict=True)
    return model


def _forward(mesh: Mesh, p: dict) -> np.ndarray:
    """The model's logits on this rank's edge shard."""
    forward = make_sharded_forward(_model(mesh, p), mesh, **p.get(
        'call_kwargs', {}))
    with torch.no_grad():
        return forward(_batch(p['shards'][mesh.gp_rank])).numpy()


def _train(mesh: Mesh, p: dict) -> dict:
    """``steps`` optimiser steps on this rank's piece of each step's batch
    (``batches[t][rank]``): the per-step losses and the final weights."""
    model = _model(mesh, p)
    opt = build_optimiser(model.parameters(), p['optimiser'], p['wd'],
                          p['lr'])
    if mesh.n_dp == 1:
        step = make_sharded_train_step(model, opt, p['task'], 'mse', mesh)
    else:
        step = make_train_step_2d(model, opt, p['task'], 'mse', mesh,
                                  multitask=p.get('multitask', False))
    losses = [float(step(_batch(pieces[mesh.rank]), p['lr'], key))
              for pieces, key in zip(p['batches'], p['keys'])]
    return {'losses': losses,
            'state_dict': {k: v.detach().numpy().copy()
                           for k, v in model.state_dict().items()}}


CASES = {'aggregate': _aggregate, 'forward': _forward, 'train': _train}


def _entry(rank: int, world: int, init_method: str, cases: dict,
           out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=init_method,
                            world_size=world, rank=rank)
    try:
        out = {}
        for name, (kind, payload) in cases.items():
            mesh = Mesh(payload['n_gp'])
            out[name] = CASES[kind](mesh, payload)
        with open(Path(out_dir) / f'rank{rank}.pkl', 'wb') as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, cases: dict) -> list:
    """``cases``: name -> (kind, payload). Returns, per rank, name ->
    result."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_entry, nprocs=world, join=True,
                 args=(world, f'tcp://127.0.0.1:{free_port()}', cases, tmp))
        results = []
        for rank in range(world):
            with open(Path(tmp) / f'rank{rank}.pkl', 'rb') as f:
                results.append(pickle.load(f))
    return results
