"""Each cell driven whole on the CPU at a tiny size: the port against the
plain reference, the result line's keys, the control, and each fault the
cell can have planted under the timed path, which must come out as not
correct. The harness's look for a card is skipped (``run_cell`` is given
the CPU)."""
import json

import pytest
import torch

from pvsbench import control, harness

# Sizes a CPU holds. Training batches keep 32 graphs: with fewer, a leaf's
# change can hang on one element whose decayed gradient is zero to
# rounding, which Adam moves by the full step either way (at 16 graphs a
# seed in a few reads past the limit).
TINY = {
    'rescreen_readme6l_b256': {'poses': 16, 'batch_size': 4,
                               'check_sample': 16},
    'train_readme6l_b256_store': {'poses': 64, 'batch_size': 32,
                                  'layers': 2},
}
SEED = 2 ** 31 + 12345   # past 32 signed bits: seeds may be that large


def run(workload, trace=False, seed=SEED):
    harness.set_cache_dirs()
    bench = harness.manifest()
    ctx = harness.cell_context(workload, seed, 0.5, trace,
                               torch.device('cpu'), TINY[workload], bench)
    return ctx, harness.run_cell(ctx, bench)


@pytest.mark.parametrize('workload', sorted(TINY))
def test_port_matches_the_reference_and_the_line_has_its_keys(workload):
    ctx, result = run(workload)
    assert result['correct'], result['checks']
    assert set(result.pop('readings')) >= set(ctx.limits)
    assert list(result)[-1] == 'checks'
    assert {'correct', 'attempted', 'failed', 'metrics',
            'device'} <= set(result)
    assert result['failed'] == 0 and result['attempted'] > 0
    assert set(result['checks']) == set(ctx.limits)
    assert 'setup_s' in result['metrics']
    assert all(set(m) == {'value', 'unit'}
               for m in result['metrics'].values())
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics_only():
    ctx, result = run('train_readme6l_b256_store', trace=True)
    assert result['correct'], result['checks']
    assert 'setup_s' not in result['metrics']
    assert 'mfu.train' in result['metrics']   # the CPU has no device trace
    assert {'busy_s', 'window_s'} <= set(result['device'])


@pytest.mark.parametrize('workload', sorted(TINY))
def test_control_fails_the_limits(workload):
    """The reference in TF32 in the program's place reads past at least
    one of the cell's limits."""
    harness.set_cache_dirs()
    ctx = harness.cell_context(workload, 7, 0, False, torch.device('cpu'),
                               TINY[workload])
    got = control.readings(ctx)['control']
    assert any(got[name] > limit for name, limit in ctx.limits.items()), got


def _unchanged_state(monkeypatch):
    from pointvs_tpu_torch.parallel import steps
    original = steps.clip_and_step
    monkeypatch.setattr(steps, 'clip_and_step',
                        lambda opt, lr: original(opt, 0.0))


def _half_batch_train(monkeypatch):
    from pointvs_tpu_torch.parallel import steps
    original = steps.loss_fn

    def half(logits, batch, task, regression_loss='mse'):
        mask = batch.graph_mask.clone().reshape(-1)
        real = torch.nonzero(mask > 0).reshape(-1)
        mask[real[len(real) // 2:]] = 0
        return original(logits, batch._replace(
            graph_mask=mask.reshape(batch.graph_mask.shape)), task,
            regression_loss)
    monkeypatch.setattr(steps, 'loss_fn', half)


def _moments_reset_each_epoch(monkeypatch):
    """Adam's state dropped between epochs."""
    from pointvs_tpu_torch.training import engine
    original = engine.Trainer.train_model

    def train_model(self, *args, **kwargs):
        self.optimiser.state.clear()
        return original(self, *args, **kwargs)
    monkeypatch.setattr(engine.Trainer, 'train_model', train_model)


def _rate_halved_after_first_epoch(monkeypatch):
    """A learning-rate schedule that goes wrong from the second epoch."""
    from pointvs_tpu_torch.training import engine
    original = engine.make_lr_schedule
    calls = []

    def schedule(*args, **kwargs):
        calls.append(1)
        rate = original(*args, **kwargs)
        return rate if len(calls) == 1 else (lambda step: 0.5 * rate(step))
    monkeypatch.setattr(engine, 'make_lr_schedule', schedule)


def _screen_step(monkeypatch, alter):
    from pointvs_tpu_torch import screen
    original = screen.make_eval_step

    def make(*args, **kwargs):
        step = original(*args, **kwargs)
        return lambda batch: alter(step(batch).clone())
    monkeypatch.setattr(screen, 'make_eval_step', make)


def _answer_altered(monkeypatch):
    def alter(logits):
        logits[0] += 1.0
        return logits
    _screen_step(monkeypatch, alter)


def _half_batch_screen(monkeypatch):
    def alter(logits):
        logits[logits.shape[0] // 2:] = 0.0
        return logits
    _screen_step(monkeypatch, alter)


FAULTS = [('train_readme6l_b256_store', _unchanged_state),
          ('train_readme6l_b256_store', _half_batch_train),
          ('train_readme6l_b256_store', _moments_reset_each_epoch),
          ('train_readme6l_b256_store', _rate_halved_after_first_epoch),
          ('rescreen_readme6l_b256', _answer_altered),
          ('rescreen_readme6l_b256', _half_batch_screen)]


@pytest.mark.parametrize('workload,fault', FAULTS,
                         ids=[f'{w}-{f.__name__[1:]}' for w, f in FAULTS])
def test_planted_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    _, result = run(workload)
    assert not result['correct'], result['checks']


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the screen cell through the command, on the card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, str(harness.PACKAGE / 'run.py'), '--workload',
         'rescreen_readme6l_b256', '--seed', str(SEED), '--seconds', '2',
         '--trace', '0'], capture_output=True, text=True, check=True,
        cwd=harness.REPO)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'] and result['device']['platform'] == 'gpu'
