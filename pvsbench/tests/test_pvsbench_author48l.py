"""The cell ``rescreen_author48l_b256`` driven whole on the CPU at a tiny
size: the port against the plain reference's mean of three outputs, the
reference in TF32 in the port's place, and the faults planted under the
timed path, which must come out as not correct."""
import pytest
import torch

from pvsbench import harness, inputs
from pvsbench.reference import egnn as ref_egnn
from pvsbench.tests import test_pvsbench_cells as cells

CELL = 'rescreen_author48l_b256'
TINY = {'poses': 16, 'batch_size': 4, 'check_sample': 16, 'layers': 4}


def run(trace=False):
    harness.set_cache_dirs()
    bench = harness.manifest()
    ctx = harness.cell_context(CELL, cells.SEED, 0.5, trace,
                               torch.device('cpu'), TINY, bench)
    return ctx, harness.run_cell(ctx, bench)


def test_port_matches_the_reference():
    ctx, result = run()
    assert result['correct'], result['checks']
    assert result['failed'] == 0 and result['attempted'] >= 16
    assert set(result['checks']) == set(ctx.limits) \
        == {'score_gap', 'rank_faults'}
    assert {'screen_poses_per_s', 'setup_s'} == set(result['metrics'])


def test_traced_run_reports_each_metric_listing_the_cell():
    """Each per-layer metric that lists the cell, but those of the device
    trace, which the CPU has not."""
    _, result = run(trace=True)
    assert result['correct'], result['checks']
    want = {m['name'] for m in harness.manifest()['per_layer']
            if CELL in m['workloads'] and m['source'] != 'device_trace'}
    assert 'featurise_ms_per_pose.screen' in want
    assert set(result['metrics']) == want


def test_control_fails_the_limits(tmp_path):
    """The reference in TF32 in the port's place, on the cell's inputs and
    weights, reads past the score's limit."""
    harness.set_cache_dirs()
    ctx = harness.cell_context(CELL, 7, 0, False, torch.device('cpu'), TINY)
    kind = harness.kind_module(ctx.traffic['kind'])
    flags = ctx.config['flags']
    ctx.schema = ref_egnn.param_schema(flags['channels'], flags['layers'],
                                       ctx.config['dim_input'],
                                       dim_output=kind.OUTPUTS)
    poses = inputs.write_pose_set(ctx.traffic, ctx.seed, tmp_path)
    weights = inputs.make_weights(ctx.schema, ctx.seed, ctx.device)
    state = dict(poses=poses, weights=weights)
    sample = kind.rescreen.check_sample(ctx, len(poses['files']))
    ref = kind.reference_scores(ctx, state, sample, ref_egnn.Precision(False))
    low = kind.reference_scores(ctx, state, sample, ref_egnn.Precision(True))
    assert float(abs(low - ref).max()) > ctx.limits['score_gap']


@pytest.mark.parametrize('fault', [cells._answer_altered,
                                   cells._half_batch_screen],
                         ids=['answer_altered', 'half_batch_screen'])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, result = run()
    assert not result['correct'], result['checks']
