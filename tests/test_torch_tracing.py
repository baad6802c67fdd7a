"""The port's spans (``pointvs_tpu_torch/tracing.py``), on the CPU.

With no profiler running, ``span`` is one shared no-op and makes no
``record_function``. Under ``torch.profiler.profile`` a small
``Trainer.train_model`` from the device store records each training span
as often as the loop runs it, with the step's collation, forward,
backward and optimiser inside ``pointvs.train.step``, and the program
keeps the same spans for ``take_spans``; a re-screen from ``--cache_dir``
records the screen's ten spans in order, one after the other, inside the
call; and a ``Trainer(profile=True)`` run's exported trace holds the
step's span.
"""
import json

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pointvs_tpu_torch import tracing
from pointvs_tpu_torch.config import model_kwargs_from_args, parse_args
from pointvs_tpu_torch.data.dataset import PointCloudDataset
from pointvs_tpu_torch.data.loader import GraphDataLoader
from pointvs_tpu_torch.screen import screen
from pointvs_tpu_torch.training.engine import Trainer
from pointvs_tpu_torch.utils import save_yaml
from tests.setup_and_params import RESOURCES

CPU = torch.device('cpu')
MODEL = dict(dim_input=12, dim_output=1, k=16, num_layers=1)
SCREEN_SPANS = ['collect', 'load_model', 'dataset', 'cache_key',
                'store_load', 'bucket', 'store_upload', 'eval', 'drain',
                'rank_write']


def _types(tmp_path, n):
    path = tmp_path / f'poses_{n}.types'
    path.write_text(''.join(f'{i % 2} -1 -1 rec_0.parquet lig_0.parquet\n'
                            for i in range(n)))
    return path


def _loader(tmp_path, n, batch_size):
    dataset = PointCloudDataset(
        RESOURCES, _types(tmp_path, n), radius=6, edge_radius=4,
        compact=True, polar_hydrogens=False, model_task='classification')
    return GraphDataLoader(dataset, batch_size=batch_size, mode='train',
                           seed=3)


def _ranges(prof) -> list:
    """(start, end, name) of the profiler's ``pointvs.`` ranges."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith('pointvs.'))


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) made')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    tracing.take_spans()
    first = tracing.span('pointvs.a')
    assert first is tracing.span('pointvs.b') is tracing.NO_SPAN
    with first:
        pass
    assert tracing.take_spans() == []


def test_training_spans_nest_in_the_step(tmp_path):
    """Three steps of one epoch (batch 2 of 6 graphs, the store, the
    producer thread): one next_batch for each batch and one that finds
    the end; the stats fetched at batch 0 and at the last batch; the
    one-layer model's layer and its aggregation inside each forward."""
    trainer = Trainer('egnn', tmp_path / 'run', CPU, silent=True,
                      device_cache='on', **MODEL)
    loader = _loader(tmp_path, 6, 2)
    tracing.take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_model(loader, epochs=1)
    ranges = _ranges(prof)
    counts = {}
    for _, _, name in ranges:
        counts[name] = counts.get(name, 0) + 1
    assert counts == {
        'pointvs.train.epoch_setup': 1, 'pointvs.train.next_batch': 4,
        'pointvs.train.step': 3, 'pointvs.step.collate': 3,
        'pointvs.step.forward': 3, 'pointvs.step.backward': 3,
        'pointvs.step.optimiser': 3, 'pointvs.train.fetch_stats': 2,
        'pointvs.train.epoch_end': 1, 'pointvs.model.layer': 3,
        'pointvs.model.aggregate': 3}
    steps = [(a, b) for a, b, n in ranges if n == 'pointvs.train.step']
    forwards = [(a, b) for a, b, n in ranges if n == 'pointvs.step.forward']
    for a, b, name in ranges:
        if name.startswith('pointvs.step.'):
            assert any(lo <= a and b <= hi for lo, hi in steps), name
        if name.startswith('pointvs.model.'):
            assert any(lo <= a and b <= hi for lo, hi in forwards), name
    kept = tracing.take_spans()
    assert sorted(n for n, _, _ in kept) == sorted(n for _, _, n in ranges)
    assert all(a <= b for _, a, b in kept)


def _run_dir(root):
    """A run directory as the training CLI leaves it, with a one-layer
    model's initial weights as its pose checkpoint."""
    args = parse_args(['egnn', str(root), '--layers', '1', '-k', '16',
                       '--compact', '--radius', '6', '--edge_radius', '4',
                       '--egnn_attention', '--softmax_attention'])
    trainer = Trainer('egnn', root, CPU, silent=False,
                      **model_kwargs_from_args(args, 12))
    save_yaml(vars(args), root / 'cmd_args.yaml')
    trainer.save(root / 'checkpoints' / 'pose_ckpt_epoch_1.pt')
    return root


def test_rescreen_spans_tile_the_call_in_order(tmp_path):
    run = _run_dir(tmp_path / 'run')
    lib = tmp_path / 'lib'
    lib.mkdir()
    for i in range(3):
        (lib / f'pose_{i}.parquet').write_bytes(
            (RESOURCES / 'lig_0.parquet').read_bytes())
    job = dict(model_path=run, receptor=RESOURCES / 'rec_0.parquet',
               ligands=str(lib), output=str(tmp_path / 'hits.csv'),
               batch_size=2, cache_dir=str(tmp_path / 'cache'),
               device='cpu')
    screen(**job)   # featurises the library and caches its store
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('call'):
            result = screen(**job)
    assert result.path == 'resident' and len(result.rows) == 3
    call = next((e.start_ns(), e.end_ns())
                for e in prof.profiler.kineto_results.events()
                if e.name() == 'call')
    ranges = [r for r in _ranges(prof) if r[2].startswith('pointvs.screen')]
    assert [n for _, _, n in ranges] == [f'pointvs.screen.{s}'
                                         for s in SCREEN_SPANS]
    assert call[0] <= ranges[0][0] and ranges[-1][1] <= call[1]
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))


def test_profile_trace_holds_the_step_span(tmp_path):
    """``profile`` traces the first epoch from its fourth step."""
    trainer = Trainer('egnn', tmp_path / 'run', CPU, silent=True,
                      profile=True, device_cache='on', **MODEL)
    trainer.train_model(_loader(tmp_path, 4, 1), epochs=1)
    traces = list((tmp_path / 'run' / 'profile').glob('*.json'))
    assert len(traces) == 1
    names = {e.get('name') for e in json.loads(
        traces[0].read_text())['traceEvents']}
    assert 'pointvs.train.step' in names
