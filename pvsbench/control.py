"""The control and the planted faults of a cell's check: the readings that
set the upper end of each limit (``PERF.md`` gives them).

    python3 -m pvsbench.control --workload <name> --seeds 1 2 3

runs, for each seed, the cell's inputs and weights and the plain
reference in the program's place, computed in the next precision below
the configuration's (TF32 for float32 with TF32 off), and prints the
numbers the check compares as one JSON line a seed. A training cell also
reads the fault that leaves half of each batch out (the reference on the
batches' first halves); a step that leaves the state unchanged reads 1 on
``change_gap`` and needs no run. For a training cell's numbers of the
last epoch's first step the program runs its set-up and a window of
``--seconds`` (the cell's own), and the control and the fault take that
step from the program's state at the epoch's start, as the check does;
the program's own readings of that run are printed beside them. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import shutil
import tempfile
from pathlib import Path

import torch

from pvsbench import harness, inputs
from pvsbench.reference import egnn as ref_egnn
from pvsbench.trace import Tracer


def readings(ctx) -> dict:
    """{'control': numbers[, 'half_batch': numbers, 'program': numbers]}
    of one seed."""
    kind = harness.kind_module(ctx.traffic['kind'])
    ctx.work = Path(tempfile.mkdtemp(prefix='pvsbench-control-')).resolve()
    f32, tf32 = ref_egnn.Precision(False), ref_egnn.Precision(True)
    try:
        if ctx.traffic['kind'] == 'rescreen':
            poses = inputs.write_pose_set(ctx.traffic, ctx.seed,
                                          ctx.work / 'data')
            weights = {k: v.cpu() for k, v in inputs.make_weights(
                ctx.schema, ctx.seed, ctx.device).items()}
            state = dict(poses=poses, weights=weights)
            files = poses['files']
            sample = kind.check_sample(ctx, len(files))
            ref = kind.reference_scores(ctx, state, sample, f32)
            low = kind.reference_scores(ctx, state, sample, tf32)
            return {'control': {'score_gap': float(abs(low - ref).max()),
                                'rank_faults': 0}}
        # The program's set-up and window, for the state at the start of
        # the window's last epoch; its own readings come with them.
        state = kind.setup(ctx)
        obs = kind.window(ctx, state, Tracer(False, 1, 0))
        kind.release(state)
        gc.collect()
        if ctx.device.type == 'cuda':
            torch.cuda.empty_cache()
        out = {'program': kind.check(ctx, state, obs)}
        batches = kind.Batches(ctx, state)
        ref = kind.reference_readings(ctx, state, batches, f32)
        last = state['last_epoch']

        def last_step(prec, half):
            return kind.replay(ctx, batches, last['params'],
                               [(last['step'], half)], prec,
                               last['moments'])
        ref_last = last_step(f32, False)
        for name, prec, half in (('control', tf32, False),
                                 ('half_batch', f32, True)):
            losses, first, _, after, _ = kind.reference_readings(
                ctx, state, batches, prec, half)
            out[name] = kind.readings(ctx, state, losses, first, after, ref)
            run = last_step(prec, half)
            out[name].update(kind.step_readings(
                run[0][0], last['params'], run[3], ref_last))
        return out
    finally:
        shutil.rmtree(ctx.work, ignore_errors=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--seconds', type=float, default=0,
                        help="a training cell's window before its last "
                             "epoch's step is read (the cell's own length)")
    args = parser.parse_args(argv)
    harness.set_cache_dirs()
    device = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    for seed in args.seeds:
        ctx = harness.cell_context(args.workload, seed, args.seconds, False,
                                   device)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'device': device.type, **readings(ctx)}),
              flush=True)


if __name__ == '__main__':
    main()
