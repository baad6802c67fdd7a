"""The port's spans as the benchmark reads them (``spans.py``): the idle
device time by the innermost span on synthetic events, the eight
per-layer metrics of a traced tiny CPU run of each cell, and no metric
from a program without spans."""
import sys

import pytest
import torch

from pvsbench import harness, spans, trace
from pvsbench.tests.test_pvsbench_cells import run

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
NEW = {'train_readme6l_b256_store': [
           'loader_wait_ms.train', 'step_host_ms.train', 'collate_ms.train',
           'optimiser_ms.train', 'epoch_overhead_ms.train'],
       'rescreen_readme6l_b256': [
           'library_scan_ms.screen', 'store_ms.screen', 'eval_ms.screen']}


class Event:
    def __init__(self, name, start, end, device=CPU, annotation=False,
                 thread=1):
        self._name, self._start, self._end = name, start, end
        self._device, self._annotation = device, annotation
        self._thread = thread

    def start_thread_id(self):
        return self._thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation


def synthetic(extra=()):
    """A window of 100 ns: kernels at 0-20 and 60-100, a ``pvsbench.``
    span over 0-100 and a ``pointvs.`` span over 10-70 around the idle
    gap 20-60, the latter mirrored onto the device timeline."""
    return [Event(trace.WINDOW_SPAN, 0, 100),
            Event('pvsbench.train.epoch', 0, 100),
            Event('pointvs.train.step', 10, 70),
            Event('kernel_a', 0, 20, CUDA), Event('kernel_b', 60, 100, CUDA),
            Event('pointvs.train.step', 20, 60, CUDA, annotation=True),
            *extra]


def test_program_gaps_name_the_inner_span_and_leave_annotations_out():
    summary = trace.summarise(synthetic())
    assert summary['busy_s'] == pytest.approx(60e-9)
    assert summary['gaps'] == {'pvsbench.train.epoch': pytest.approx(40e-9)}
    got = spans.program_gaps(synthetic())
    assert got['gaps'] == {'pointvs.train.step': pytest.approx(40e-9)}
    assert got['in_program_s'] == got['idle_s'] == pytest.approx(40e-9)
    assert got['named_work_s'] == 0


def test_program_gaps_report_named_device_work():
    """A ``pointvs.`` event that is not an annotation is device work, as
    ``trace.summarise`` counts it, and is reported."""
    events = synthetic([Event('pointvs.decode', 30, 40, CUDA)])
    assert trace.summarise(events)['busy_s'] == pytest.approx(70e-9)
    got = spans.program_gaps(events)
    assert got['named_work_s'] == pytest.approx(10e-9)
    assert got['idle_s'] == pytest.approx(30e-9)


def test_gaps_split_by_span_and_self_times():
    events = [Event(trace.WINDOW_SPAN, 0, 100),
              Event('pointvs.a', 0, 50), Event('pointvs.b', 10, 30),
              Event('pointvs.c', 12, 20), Event('k1', 0, 5, CUDA),
              Event('k2', 16, 18, CUDA), Event('k3', 60, 70, CUDA)]
    got = spans.program_gaps(events)
    # Gaps 5-16, 18-60 and 70-100, split by the innermost span open.
    assert got['gaps'] == {'pointvs.a': pytest.approx(25e-9),
                           'pointvs.b': pytest.approx(12e-9),
                           'pointvs.c': pytest.approx(6e-9),
                           'outside_spans': pytest.approx(40e-9)}
    assert got['in_program_s'] == pytest.approx(43e-9)
    table = spans.span_table(events)
    assert table['pointvs.a']['self_ms'] == pytest.approx(30e-6)
    assert table['pointvs.b']['self_ms'] == pytest.approx(12e-6)
    assert table['pointvs.c']['count'] == 1


def test_medians_within_a_span():
    obs = {'kind': 'train', 'program_spans': [
        ('pointvs.train.step', 0, 10_000_000),
        ('pointvs.step.collate', 1_000_000, 3_000_000),
        ('pointvs.step.collate', 20_000_000, 29_000_000)]}
    assert spans.median_ms(obs, 'train', ['pointvs.step.collate']) == 5.5
    assert spans.median_ms(obs, 'train', ['pointvs.step.collate'],
                           within='pointvs.train.step') == 2.0
    assert spans.median_ms(obs, 'screen', ['pointvs.step.collate']) is None
    assert spans.median_ms(obs, 'train', ['pointvs.screen.eval']) is None


@pytest.mark.parametrize('workload', sorted(NEW))
def test_traced_run_reports_the_program_span_metrics(workload):
    _, result = run(workload, trace=True)
    assert result['correct'], result['checks']
    for name in NEW[workload]:
        value = result['metrics'][name]['value']
        assert isinstance(value, float) and value >= 0, name


def test_a_program_without_spans_gives_no_metric(monkeypatch):
    monkeypatch.setitem(sys.modules, 'pointvs_tpu_torch.tracing', None)
    for workload, names in NEW.items():
        kind = 'train' if workload.startswith('train') else 'screen'
        for name in names:
            assert harness.metric_reader(name)({'kind': kind}) is None


def test_host_ops_count_self_time_per_thread():
    """An op's self time leaves out the ops nested in it on its thread,
    and not an op of another thread that overlaps it."""
    us = 1000   # ns
    events = [Event(trace.WINDOW_SPAN, 0, 1000 * us),
              Event('pointvs.step.forward', 0, 500 * us),
              Event('aten::linear', 10 * us, 110 * us),
              Event('aten::mm', 20 * us, 80 * us),
              Event('aten::mm', 200 * us, 260 * us),
              Event('aten::mul', 30 * us, 90 * us, thread=2),
              Event('aten::add', 600 * us, 700 * us)]
    assert spans.host_ops(events) == {
        'aten::mm': [2, 0.12], 'aten::add': [1, 0.1],
        'aten::mul': [1, 0.06], 'aten::linear': [1, 0.04]}
    assert 'aten::add' not in spans.host_ops(
        events, ('pointvs.step.forward',))


def test_traced_units_against_the_others():
    train = {'kind': 'train', 'step_ms': [9, 9, 1, 2, 3, 4, 8, 8]}
    assert spans.traced_against_untraced(train, 4, 1, 2) == {
        'step_ms': {'traced': 2.5, 'untraced': 8.5}}
    screen = {'kind': 'screen', 'seconds': [{'total': t}
                                            for t in (1.0, 2.0, 4.0)]}
    assert spans.traced_against_untraced(screen, 3, 1, 2) == {
        'call_ms': {'traced': 3000.0, 'untraced': 1000.0}}


def test_callers_name_the_outermost_operation_of_each_wait():
    us = 1000
    events = [Event(trace.WINDOW_SPAN, 0, 1000 * us),
              Event('pointvs.step.forward', 0, 500 * us),
              Event('aten::nonzero', 10 * us, 110 * us),
              Event('aten::copy_', 20 * us, 90 * us),
              Event('cudaStreamSynchronize', 30 * us, 80 * us),
              Event('cudaStreamSynchronize', 200 * us, 210 * us),
              Event('autograd::engine::evaluate_function: MulBackward0',
                    300 * us, 400 * us, thread=2),
              Event('cudaStreamSynchronize', 310 * us, 330 * us, thread=2)]
    assert spans.callers(events) == {
        'aten::nonzero': [1, 0.05],
        'autograd::engine::evaluate_function: MulBackward0': [1, 0.02],
        'cudaStreamSynchronize': [1, 0.01]}
