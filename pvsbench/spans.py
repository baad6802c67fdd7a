"""The port's own spans (``pointvs_tpu_torch/tracing.py``) in a traced run:
what the per-layer metrics under ``metrics/`` read from them, and the
device's idle time by the span the host was in.

The program keeps each span that closes while a profiler records, which
in a ``--trace 1`` run is the traced units of the window. ``recorded``
takes them from the program once a run and keeps them in the window's
observations, where every reader finds them; a program without spans
gives none, and each reader then returns nothing.

    python3 -m pvsbench.spans --workload <name> --seed <n> --seconds <s> \\
        [--set batch_size=512]

runs a cell traced, as ``run.py --trace 1`` does (``--set`` replaces a
traffic parameter or a configuration flag by name), and prints one JSON
line: the median step or re-screen of the traced units and of the others
(``traced_against_untraced``), the traced units' idle device seconds by
the innermost ``pointvs.`` or ``pvsbench.`` span open on the host over
each part of each gap, and the share of them inside a ``pointvs.`` span
(``gaps``), the seconds of
device work that carry a ``pointvs.`` name and that ``trace.summarise``
would count as busy (``named_work_s``, 0 where it leaves the program's
annotations out), each span's count, median and self time, the host
operations with the most self time in the traced units and in the step's
forward and backward spans (``host_ops``), the operations whose host
waits for the device (``syncs_by_caller``), the per-layer metrics and the
cost of one span with and without a profiler on this host
(``span_us``). The run's rate (``end_to_end``) counts the trace's own
processing after the traced units, so it is not a ``--trace 0`` rate.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time

import torch

from pvsbench import harness, trace

PROGRAM = 'pointvs.'
PREFIXES = (PROGRAM, 'pvsbench.')


def recorded(obs: dict) -> list:
    """The program's spans of this run, ``(name, start_ns, end_ns)``;
    taken from the program at the first call and kept in ``obs``."""
    if 'program_spans' not in obs:
        try:
            from pointvs_tpu_torch.tracing import take_spans
        except ImportError:   # a program without spans
            obs['program_spans'] = []
        else:
            obs['program_spans'] = take_spans()
    return obs['program_spans']


def durations_ms(spans: list, name: str, within: str | None = None) -> list:
    """Milliseconds of each span named ``name``, in order; with
    ``within``, of those inside a span named ``within``."""
    outer = [(a, b) for n, a, b in spans if n == within]
    return [(b - a) / 1e6 for n, a, b in spans
            if n == name and (within is None
                              or any(lo <= a and b <= hi
                                     for lo, hi in outer))]


def median_ms(obs: dict, kind: str, names: list,
              within: str | None = None):
    """The sum over ``names`` of each span's median milliseconds in a
    window of ``kind``; None where a span is missing."""
    if obs['kind'] != kind:
        return None
    spans = recorded(obs)
    total = 0.0
    for name in names:
        found = durations_ms(spans, name, within)
        if not found:
            return None
        total += statistics.median(found)
    return total


def _owners(spans: list) -> tuple:
    """(marks, names): the innermost of ``spans`` (start, end, name) open
    between each mark and the next, None where none is."""
    marks = sorted({t for a, b, _ in spans for t in (a, b)})
    names = []
    for t0, t1 in zip(marks, marks[1:]):
        mid = (t0 + t1) // 2
        owner = min((s for s in spans if s[0] <= mid <= s[1]),
                    key=lambda s: s[1] - s[0], default=None)
        names.append(owner[2] if owner else None)
    return marks, names


def _split(lo: int, hi: int, marks: list, names: list, into: dict) -> None:
    """Add the nanoseconds of ``[lo, hi)`` to ``into`` by the innermost
    span open over each part of it (None outside every span)."""
    at = bisect.bisect_right(marks, lo) - 1
    while lo < hi:
        if 0 <= at < len(names):
            name, stop = names[at], marks[at + 1]
        else:
            name = None
            stop = marks[0] if at < 0 and marks and marks[0] > lo else hi
        stop = min(stop, hi)
        into[name] = into.get(name, 0) + stop - lo
        lo, at = stop, at + 1


def program_gaps(events) -> dict:
    """The traced window's idle device seconds by the innermost span of
    either prefix open on the host over each part of each gap
    (``outside_spans`` where none is), with device work and the window as
    ``trace.summarise`` takes them (which gives a whole gap to the span
    open at its midpoint, and sees ``pvsbench.`` spans alone); also the
    device seconds of events named ``pointvs.`` that it counts as
    work."""
    window, spans, device, named_work = None, [], [], 0
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not trace._is_annotation(e):
                device.append((e.start_ns(), e.end_ns()))
                if name.startswith(PROGRAM):
                    named_work += e.end_ns() - e.start_ns()
        elif name == trace.WINDOW_SPAN:
            window = (e.start_ns(), e.end_ns())
        elif name.startswith(PREFIXES):
            spans.append((e.start_ns(), e.end_ns(), name))
    out = {'gaps': {}, 'idle_s': 0.0, 'in_program_s': 0.0,
           'named_work_s': named_work / 1e9}
    if window is None:
        return out
    lo, hi = window
    marks, names = _owners(spans)
    idle, end = {}, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in device
                       if b > lo and a < hi) + [(hi, hi)]:
        if a > end:
            _split(end, a, marks, names, idle)
        end = max(end, b)
    for name, ns in idle.items():
        key = name or 'outside_spans'
        out['gaps'][key] = ns / 1e9
        out['idle_s'] += ns / 1e9
        if key.startswith(PROGRAM):
            out['in_program_s'] += ns / 1e9
    return out


def _threads(events, keep) -> list:
    """The host events that ``keep(name)`` accepts, as one list a thread
    of ``(start_ns, end_ns, name)`` sorted outer before inner."""
    by_thread = {}
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                and keep(e.name()):
            by_thread.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns(), e.name()))
    return [sorted(rows, key=lambda r: (r[0], -r[1]))
            for rows in by_thread.values()]


def _self_times(rows: list):
    """``(start, end, name, self ns)`` of each of one thread's nested
    events: its time less that of the events directly inside it."""
    stack = []   # [start, end, name, ns of children]
    for a, b, name in rows + [(float('inf'), float('inf'), None)]:
        while stack and stack[-1][1] <= a:
            done = stack.pop()
            if stack:
                stack[-1][3] += done[1] - done[0]
            yield done[0], done[1], done[2], done[1] - done[0] - done[3]
        if name is not None:
            stack.append([a, b, name, 0])


def _window(events, names) -> list:
    return [(e.start_ns(), e.end_ns()) for e in events if e.name() in names]


def span_table(events) -> dict:
    """Each span name of either prefix: its count, median milliseconds
    and total self milliseconds (its time less that of the spans nested
    in it)."""
    table = {}
    for rows in _threads(events, lambda n: n.startswith(PREFIXES)):
        for a, b, name, own in _self_times(rows):
            row = table.setdefault(name, {'ms': [], 'self_ms': 0.0})
            row['ms'].append((b - a) / 1e6)
            row['self_ms'] += own / 1e6
    return {name: {'count': len(row['ms']),
                   'median_ms': statistics.median(row['ms']),
                   'self_ms': row['self_ms']}
            for name, row in sorted(table.items())}


def span_us(calls: int = 20000) -> dict:
    """Microseconds of one ``span`` entered and left, with no profiler
    and under a CPU profiler, on this host."""
    from torch.profiler import ProfilerActivity, profile
    from pointvs_tpu_torch.tracing import span, take_spans

    def per_call():
        start = time.perf_counter()
        for _ in range(calls):
            with span('pointvs.cost'):
                pass
        return (time.perf_counter() - start) / calls * 1e6
    off = per_call()
    with profile(activities=[ProfilerActivity.CPU]):
        on = per_call()
    take_spans()
    return {'off': off, 'on': on}


def _ranked(totals: dict, top: int) -> dict:
    ranked = sorted(totals.items(), key=lambda t: -t[1][1])[:top]
    return {name: [calls, round(ms, 3)] for name, (calls, ms) in ranked}


def host_ops(events, within: tuple = (), top: int = 12) -> dict:
    """The host operations with the most self time in the traced window
    (their time less that of the operations nested in them on their
    thread), ``{name: [calls, self ms]}``; with ``within``, only those
    that start inside a span of one of those names."""
    window = _window(events, within or (trace.WINDOW_SPAN,))
    totals = {}
    for rows in _threads(events, lambda n: not n.startswith(PREFIXES)):
        for a, _, name, own in _self_times(rows):
            if any(lo <= a <= hi for lo, hi in window):
                row = totals.setdefault(name, [0, 0.0])
                row[0] += 1
                row[1] += own / 1e6
    return _ranked(totals, top)


def callers(events, target: str = 'cudaStreamSynchronize',
            top: int = 12) -> dict:
    """Where the host waits: the outermost operation (below the spans) on
    the thread of each ``target`` event in the traced window, ``{name:
    [calls, ms of target]}``."""
    window = _window(events, (trace.WINDOW_SPAN,))
    totals = {}
    for rows in _threads(events, lambda n: not n.startswith(PREFIXES)):
        stack = []
        for a, b, name in rows:
            while stack and stack[-1][1] <= a:
                stack.pop()
            if name == target and any(lo <= a <= hi for lo, hi in window):
                row = totals.setdefault(stack[0][2] if stack else name,
                                        [0, 0.0])
                row[0] += 1
                row[1] += (b - a) / 1e6
            stack.append((a, b, name))
    return _ranked(totals, top)


def traced_against_untraced(obs: dict, units: int, start: int,
                            count: int) -> dict:
    """The median training step (``step_ms``, CUDA events) or re-screen
    (``ScreenResult.seconds['total']``) of the window's traced units
    ``[start, start + count)`` and of its other units: what the profiler
    and the spans cost a unit."""
    if obs['kind'] == 'train':
        key, values = 'step_ms', list(obs['step_ms'])
        per = len(values) // units
    else:
        key, values = 'call_ms', [1e3 * c['total'] for c in obs['seconds']]
        per = 1
    lo, hi = start * per, (start + count) * per
    parts = {'traced': values[lo:hi], 'untraced': values[:lo] + values[hi:]}
    return {key: {k: statistics.median(v) if v else None
                  for k, v in parts.items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Run one cell traced and print its idle device time '
                    'by the span the host was in.')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--set', action='append', default=[],
                        metavar='KEY=VALUE')
    parser.add_argument('--device', choices=('cuda', 'cpu'),
                        default='cuda')
    args = parser.parse_args(argv)
    harness.set_cache_dirs()
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    device = torch.device(args.device, 0) if args.device == 'cuda' \
        else torch.device('cpu')
    overrides = {}
    for item in args.set:
        key, value = item.split('=', 1)
        overrides[key] = json.loads(value)
    bench = harness.manifest()
    ctx = harness.cell_context(args.workload, args.seed, args.seconds,
                               True, device, overrides, bench)
    seen = {}
    summarise, per_layer = trace.summarise, harness.per_layer_metrics

    def keep_events(events):
        seen['events'] = list(events)
        return summarise(seen['events'])

    def keep_obs(bench_, workload, obs):
        seen['obs'] = obs
        return per_layer(bench_, workload, obs)
    trace.summarise, harness.per_layer_metrics = keep_events, keep_obs
    try:
        result = harness.run_cell(ctx, bench)
    finally:
        trace.summarise, harness.per_layer_metrics = summarise, per_layer
    kind = harness.kind_module(ctx.traffic['kind'])
    obs, events = seen['obs'], seen['events']
    gaps = program_gaps(events)
    units = obs['attempted'] // ctx.traffic['poses']
    step = ('pointvs.step.forward', 'pointvs.step.backward')
    out = {
        'workload': args.workload, 'seed': args.seed, 'overrides': overrides,
        'correct': result['correct'], 'device': result['device'],
        'end_to_end': kind.end_to_end(obs),
        'traced_against_untraced': traced_against_untraced(
            obs, units, 1, ctx.traffic['trace_units']),
        'metrics': {k: v['value'] for k, v in result['metrics'].items()},
        'in_program_share': (gaps['in_program_s'] / gaps['idle_s']
                             if gaps['idle_s'] else None),
        'gaps': dict(sorted(gaps['gaps'].items(), key=lambda t: -t[1])),
        'idle_s': gaps['idle_s'], 'named_work_s': gaps['named_work_s'],
        'spans': span_table(events), 'span_us': span_us(),
        'host_ops': host_ops(events),
        'host_ops_in_step': {name: host_ops(events, (name,))
                             for name in step},
        'syncs_by_caller': callers(events),
        'card': harness.power_limit()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
