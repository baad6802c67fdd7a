"""The per-layer metrics that read the model's layer spans and the
screen's edge counts: reported by a traced tiny CPU run of the README
re-screen cell, and nothing from a program that keeps no counts or
spans."""
import sys

import torch

from pvsbench import harness
from pvsbench.tests.test_pvsbench_cells import SEED

CELL = 'rescreen_readme6l_b256'
TINY = {'poses': 16, 'batch_size': 4, 'check_sample': 16}
NEW = ['layer_host_ms.screen', 'aggregate_host_ms.screen',
       'edge_fill.screen']


def test_traced_run_reports_the_layer_metrics():
    harness.set_cache_dirs()
    bench = harness.manifest()
    ctx = harness.cell_context(CELL, SEED, 0.5, True, torch.device('cpu'),
                               TINY, bench)
    result = harness.run_cell(ctx, bench)
    assert result['correct'], result['checks']
    metrics = {k: v['value'] for k, v in result['metrics'].items()}
    assert {'eval_ms.screen', *NEW} <= set(metrics)
    assert 0 < metrics['aggregate_host_ms.screen'] \
        < metrics['layer_host_ms.screen']
    assert 50 < metrics['edge_fill.screen'] <= 100


def test_a_program_without_counts_or_spans_gives_no_metric(monkeypatch):
    from pointvs_tpu_torch import tracing
    monkeypatch.delattr(tracing, 'take_counts')
    assert harness.metric_reader('edge_fill.screen')({'kind': 'screen'}) \
        is None
    monkeypatch.setitem(sys.modules, 'pointvs_tpu_torch.tracing', None)
    for name in NEW:
        assert harness.metric_reader(name)({'kind': 'screen'}) is None
