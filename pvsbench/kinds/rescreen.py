"""Re-screening a cached library: the traffic kind ``rescreen``.

Set-up writes the library and a run directory (the training CLI's
``cmd_args.yaml`` and ``model_kwargs.yaml`` for the configuration, and a
pose checkpoint of the benchmark's weights), screens the library once cold
with ``--cache_dir`` in the run's work directory, which featurises it and
caches its store, and once more from the cache, and flushes what they
wrote to the disk. The window calls
``pointvs_tpu_torch.screen.screen`` again and again, each call a re-screen
from the cache at the traffic's batch; its rate is the poses of the calls
it completed over its time.

The check takes a sample of the library drawn from the seed, featurises
each sampled pose and scores it with the reference, and compares every
call's score of each sampled pose; every call's rows must also be the
whole library, once each, ranked 1 to N by non-increasing score.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from pvsbench import inputs
from pvsbench.reference import egnn as ref_egnn
from pvsbench.reference import featurise as ref_feat
from pvsbench.roofline import egnn_forward_flops

SPAN = 'pvsbench.screen.call'


def write_run_dir(ctx, run, weights: dict) -> None:
    """A run directory as the training CLI leaves it, holding ``weights``
    as its pose checkpoint."""
    from pointvs_tpu_torch.config import model_kwargs_from_args, parse_args
    from pointvs_tpu_torch.utils import save_yaml
    args = parse_args([ctx.config['model'], str(run)]
                      + inputs.cli_flags(ctx.config['flags']))
    (run / 'checkpoints').mkdir(parents=True)
    save_yaml(vars(args), run / 'cmd_args.yaml')
    save_yaml(model_kwargs_from_args(args, ctx.config['dim_input']),
              run / 'model_kwargs.yaml')
    torch.save({'model_state_dict': {k: v.cpu() for k, v in weights.items()},
                'p_epoch': 0, 'a_epoch': 0},
               run / 'checkpoints' / 'pose_ckpt_epoch_0.pt')


def setup(ctx) -> dict:
    from pointvs_tpu_torch.screen import screen
    poses = inputs.write_pose_set(ctx.traffic, ctx.seed, ctx.work / 'library')
    weights = inputs.make_weights(ctx.schema, ctx.seed, ctx.device)
    write_run_dir(ctx, ctx.work / 'run', weights)
    ctx.parts.mark('inputs')
    job = dict(model_path=ctx.work / 'run',
               receptor=poses['root'] / inputs.RECEPTOR,
               ligands=str(poses['root'] / 'lig_*.parquet'),
               output=ctx.work / 'out' / 'hits.csv',
               batch_size=ctx.traffic['batch_size'],
               cache_dir=ctx.work / 'cache', device=ctx.device.type)
    cold = screen(**job)
    ctx.parts.mark('cold_screen')
    screen(**job)
    if ctx.device.type == 'cuda':
        torch.cuda.synchronize(ctx.device)
    ctx.parts.mark('warm_screen')
    # The cold screen leaves ~1.5 GB of store and per-pose caches in the
    # page cache; the kernel writes them back some 30 s later, inside the
    # window, unless they are flushed here.
    os.sync()
    ctx.parts.mark('sync')
    return dict(job=job, poses=poses,
                weights={k: v.cpu() for k, v in weights.items()},
                cold=dict(cold.seconds), cold_poses=len(cold.rows))


def window(ctx, state, tracer) -> dict:
    from torch.profiler import record_function
    from pointvs_tpu_torch.screen import screen
    calls = []
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds \
            or tracer.needs_more(len(calls)):
        tracer.before(len(calls), ctx.device)
        with record_function(SPAN):
            result = screen(**state['job'])
        tracer.after(len(calls), ctx.device)
        calls.append(result)
    window_s = time.perf_counter() - start
    n = len(state['poses']['files'])
    obs = dict(kind='screen', window_s=window_s,
               poses=sum(len(c.rows) for c in calls),
               attempted=n * len(calls),
               failed=sum(max(0, n - len({r['ligand'] for r in c.rows}))
                          for c in calls),
               seconds=[dict(c.seconds) for c in calls],
               cold=state['cold'], cold_poses=state['cold_poses'],
               trace=tracer.summary,
               rows=[c.rows for c in calls])
    if tracer.summary is not None:
        from pointvs_tpu_torch.data.device_dataset import load_host_store
        store = load_host_store(next(state['job']['cache_dir'].glob(
            'torch_store_*.bin')))
        obs['model_flops'] = len(calls) * egnn_forward_flops(
            int(store.num_nodes.sum()), int(store.num_edges.sum()), n,
            ctx.config['flags']['channels'], ctx.config['flags']['layers'])
    return obs


def release(state) -> None:
    """Nothing of the program outlives a ``screen`` call."""
    del state


def reference_scores(ctx, state, sample, prec) -> np.ndarray:
    """The reference's scores of the library's poses ``sample``."""
    flags, poses = ctx.config['flags'], state['poses']
    rec = ref_feat.read_structure(poses['root'] / inputs.RECEPTOR)
    graphs = [ref_feat.featurise(
        rec, ref_feat.read_structure(poses['files'][i]), flags['radius'],
        flags['edge_radius'], flags.get('estimate_bonds', False))
        for i in sample]
    weights = {k: v.to(ctx.device) for k, v in state['weights'].items()}
    out = []
    with torch.no_grad(), prec.active():
        for lo, hi in ref_egnn.blocks_of(graphs, ref_egnn.EDGE_BUDGET):
            b = ref_egnn.block(graphs[lo:hi], ctx.device)
            logits = ref_egnn.forward(weights, b, flags['layers'], prec)
            out.append(torch.sigmoid(logits[:, 0]).cpu().double().numpy())
    return np.concatenate(out)


def check_sample(ctx, n: int) -> np.ndarray:
    return np.sort(inputs.seeded(ctx.seed, 'sample').choice(
        n, min(n, ctx.traffic['check_sample']), replace=False))


def rank_faults(rows: list, library: set) -> int:
    """Rows out of score order, ranks other than 1..N, and ligands of the
    library missing or repeated."""
    scores = np.array([r['score'] for r in rows])
    ranks = [r['rank'] for r in rows]
    names = [r['ligand'] for r in rows]
    return (int((np.diff(scores) > 0).sum())
            + int(ranks != list(range(1, len(rows) + 1)))
            + len(library.symmetric_difference(names))
            + len(names) - len(set(names)))


def score_gap(all_rows: list, files: list, sample, ref: np.ndarray) -> float:
    """The widest gap between a call's score of a sampled pose and the
    reference's (1 where a call has no row for it)."""
    gap = 0.0
    for rows in all_rows:
        by_name = {r['ligand']: r['score'] for r in rows}
        for i, want in zip(sample, ref):
            got = by_name.get(str(files[i]))
            gap = max(gap, 1.0 if got is None else abs(got - want))
    return float(gap)


def check(ctx, state, obs) -> dict:
    files = state['poses']['files']
    sample = check_sample(ctx, len(files))
    ref = reference_scores(ctx, state, sample, ref_egnn.Precision(False))
    library = {str(f) for f in files}
    return {'score_gap': score_gap(obs['rows'], files, sample, ref),
            'rank_faults': max(rank_faults(rows, library)
                               for rows in obs['rows'])}


def end_to_end(obs) -> dict:
    return {'screen_poses_per_s': obs['poses'] / obs['window_s']}
