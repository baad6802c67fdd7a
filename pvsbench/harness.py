"""The benchmark harness: finds a cell's configuration, traffic mix,
limits and per-layer metrics by name, runs its set-up, window and check,
and prints the result.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness reads ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``limits/<workload>.json``; the traffic's ``kind`` names the module under
``kinds/`` that drives the program (``setup``, ``window``, ``release``,
which drops the program's state before the check, ``check``,
``end_to_end``); each per-layer metric is the ``read``
function of ``metrics/<name>.py``, given the window's observations.
Adding a cell, a mix or a metric adds files and entries and edits none.

Every build and kernel cache of the program is kept inside the checkout
(``CACHE``): the port's native graph library (``POINTVS_NATIVE_CACHE``),
CUDA's JIT cache, and Triton's and torch's extension directories; the
port's own CUDA kernels build into ``pointvs_tpu_torch/ops/build/``. The
pose pools are written there too, once (``inputs.pose_pool``); the rest of
the run's data lives in a directory under ``TMPDIR``, removed at the end.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

PACKAGE = Path(__file__).resolve().parent
REPO = PACKAGE.parent
CACHE = PACKAGE / '.cache'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pointvs_tpu')


def set_cache_dirs() -> None:
    for var, sub in (('POINTVS_NATIVE_CACHE', 'native'),
                     ('CUDA_CACHE_PATH', 'cuda'),
                     ('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ[var] = str(CACHE / sub)


def manifest() -> dict:
    return json.loads((REPO / 'BENCHMARK.json').read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((PACKAGE / kind / f'{name}.json').read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f'pvsbench_{path.parent.name}_{path.stem}'.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind_module(kind: str):
    return load_module(PACKAGE / 'kinds' / f'{kind}.py')


def metric_reader(name: str):
    return load_module(PACKAGE / 'metrics' / f'{name}.py').read


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not load."""
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN))


def process_start() -> float:
    """This process's start, as ``time.time()`` reads it."""
    try:
        fields = Path('/proc/self/stat').read_text().rsplit(')', 1)[1]
        ticks = int(fields.split()[19])
        boot = next(int(line.split()[1]) for line in
                    Path('/proc/stat').read_text().splitlines()
                    if line.startswith('btime'))
        return boot + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError, StopIteration):
        return STARTED


STARTED = time.time()


def cell_context(workload: str, seed: int, seconds: float, trace: bool,
                 device, overrides: dict | None = None,
                 bench: dict | None = None) -> SimpleNamespace:
    """Everything a kind needs about the cell. ``overrides`` replaces
    traffic parameters and configuration flags by name (the CPU tests run
    cells at a tiny size)."""
    from pvsbench.reference import egnn
    bench = bench or manifest()
    cell = next(w for w in bench['workloads'] if w['name'] == workload)
    config = load_json('configs', cell['config'])
    traffic = load_json('traffic', cell['traffic'])
    for key, value in (overrides or {}).items():
        if key in traffic:
            traffic[key] = value
        else:
            config['flags'][key] = value
    egnn.check_flags(config['flags'])
    schema = egnn.param_schema(config['flags']['channels'],
                               config['flags']['layers'],
                               config['dim_input'])
    return SimpleNamespace(
        workload=workload, config=config, traffic=traffic,
        limits=load_json('limits', workload), seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=device,
        schema=schema, work=None, parts=Parts())


class Parts:
    """Seconds of each named part of set-up, by the host clock."""

    def __init__(self):
        self.last = time.perf_counter()
        self.seconds = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


def per_layer_metrics(bench: dict, workload: str, obs: dict) -> dict:
    out = {}
    for metric in bench['per_layer']:
        if workload not in metric.get('workloads', [workload]):
            continue
        value = metric_reader(metric['name'])(obs)
        if value is not None:
            out[metric['name']] = {'value': value, 'unit': metric['unit']}
    return out


def run_cell(ctx, bench: dict) -> dict:
    """Set-up, window and check of one cell; returns the result line's
    object (without ``device``'s card fields on the CPU)."""
    import torch
    from pvsbench.trace import Tracer, breakdown
    kind = kind_module(ctx.traffic['kind'])
    ctx.work = Path(tempfile.mkdtemp(prefix='pvsbench-')).resolve()
    try:
        ctx.parts.seconds['before_setup'] = time.time() - process_start()
        ctx.parts.last = time.perf_counter()
        state = kind.setup(ctx)
        tracer = Tracer(ctx.trace, 1, ctx.traffic['trace_units'])
        window_start = time.time()
        obs = kind.window(ctx, state, tracer)
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(found)
        obs['setup_s'] = window_start - process_start()
        device = {'platform': 'gpu' if ctx.device.type == 'cuda' else 'cpu',
                  'count': 1}
        if ctx.device.type == 'cuda':
            device.update(kind=torch.cuda.get_device_name(ctx.device),
                          memory_peak_bytes=int(
                              torch.cuda.max_memory_allocated(ctx.device)))
        if ctx.trace:
            summary = obs['trace'] or {'busy_s': 0.0, 'window_s': 0.0}
            device.update(busy_s=summary['busy_s'],
                          window_s=summary['window_s'])
            metrics = per_layer_metrics(bench, ctx.workload, obs)
        else:
            e2e = dict(kind.end_to_end(obs), setup_s=obs['setup_s'])
            metrics = {m['name']: {'value': e2e[m['name']],
                                   'unit': m['unit']}
                       for m in bench['end_to_end']
                       if ctx.workload in m.get('workloads',
                                                [ctx.workload])}
        kind.release(state)
        gc.collect()
        if ctx.device.type == 'cuda':
            torch.cuda.empty_cache()
        readings = kind.check(ctx, state, obs)
    finally:
        shutil.rmtree(ctx.work, ignore_errors=True)
    checks = {name: {'value': readings[name], 'limit': limit}
              for name, limit in ctx.limits.items()}
    correct = (obs['failed'] == 0
               and all(c['value'] <= c['limit'] for c in checks.values()))
    result = {'correct': correct, 'attempted': obs['attempted'],
              'failed': obs['failed'], 'metrics': metrics, 'device': device}
    if ctx.trace and obs['trace']:
        result['breakdown'] = breakdown(obs['trace'])
    result['checks'] = checks
    result['readings'] = readings
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f'modules loaded that the benchmark may not load: '
                         f'{", ".join(names)}')


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Run one cell of BENCHMARK.json once and print its '
                    'result as the last line of standard output.')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = manifest()
    cell = next((w for w in bench['workloads']
                 if w['name'] == args.workload), None)
    if cell is None:
        print(f'no workload {args.workload!r} in BENCHMARK.json',
              file=sys.stderr)
        return 2
    set_cache_dirs()
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell['chips']:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f'{args.workload} needs {cell["chips"]} CUDA device(s); '
              f'this machine has {found}', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    ctx = cell_context(args.workload, args.seed, args.seconds, args.trace,
                       device, bench=bench)
    try:
        result = run_cell(ctx, bench)
    except ForbiddenModules as exc:
        print(str(exc), file=sys.stderr)
        return 3
    card = power_limit()
    if card:
        result['device']['power_limit'] = card
        print(f'card: {card}', file=sys.stderr)
    for name, secs in ctx.parts.seconds.items():
        print(f'setup part {name} {secs:.3f} s', file=sys.stderr)
    readings = result.pop('readings')
    checks = result.pop('checks')
    for name, value in readings.items():
        if name not in checks:
            print(f'reading {name} {value!r} (not compared)',
                  file=sys.stderr)
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    result['checks'] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
