"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and every configuration, traffic mix, limit file and metric reader found
by name."""
import json
import re

import pytest

from pvsbench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT = re.compile(r'^[^\t\n]{1,200}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


@pytest.fixture(scope='module')
def bench():
    return harness.manifest()


def test_top_level_keys_and_command(bench):
    assert set(bench) == KEYS
    assert bench['command'] == ['python3', 'pvsbench/run.py']
    assert bench['paths'] == ['pvsbench']
    assert 1 <= bench['run_seconds'] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_entry_keys(bench):
    names = set()
    for entry in bench['configs']:
        assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(entry['name']) and TEXT.match(entry['why'])
        assert TEXT.match(entry['source'])
        assert entry['file'].startswith('pvsbench/')
    for entry in bench['workloads']:
        assert set(entry) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(entry['name']) and NAME.match(entry['traffic'])
        assert entry['chips'] in (1, 4) and TEXT.match(entry['why'])
    for entry in bench['end_to_end'] + bench['per_layer']:
        allowed = ({'name', 'unit', 'better', 'bound', 'source',
                    'workloads'} if 'bound' in entry else
                   {'name', 'unit', 'better', 'source', 'layer', 'moves',
                    'workloads'})
        assert set(entry) <= allowed
        assert NAME.match(entry['name']) and UNIT.match(entry['unit'])
        assert entry['better'] in ('lower', 'higher')
        assert entry['name'] not in names
        names.add(entry['name'])
    cells = {w['name'] for w in bench['workloads']}
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for metric in bench['end_to_end']:
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25
    for metric in bench['per_layer']:
        assert TEXT.match(metric['layer'])
        assert metric['moves'] in e2e
        moved = e2e[metric['moves']].get('workloads', cells)
        assert set(metric['workloads']) <= set(moved)


def test_every_cell_and_metric_is_found_by_name(bench):
    for cell in bench['workloads']:
        config = harness.load_json('configs', cell['config'])
        traffic = harness.load_json('traffic', cell['traffic'])
        assert config['name'] == cell['config']
        assert (harness.PACKAGE / 'kinds' / f'{traffic["kind"]}.py').exists()
        assert harness.load_json('limits', cell['name'])
        entry = next(c for c in bench['configs']
                     if c['name'] == cell['config'])
        assert entry['reduced'] == config['reduced']
        assert entry['source'] == config['source']
    for metric in bench['per_layer']:
        assert callable(harness.metric_reader(metric['name']))


def test_every_cell_reports_setup_another_metric_and_a_per_layer_one(bench):
    for cell in bench['workloads']:
        e2e = [m['name'] for m in bench['end_to_end']
               if cell['name'] in m.get('workloads', [cell['name']])]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert any(cell['name'] in m['workloads']
                   for m in bench['per_layer'])
