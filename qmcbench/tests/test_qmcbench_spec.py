"""BENCHMARK.json against the benchmark's contract, and each cell against its files."""

import json
import re

import pytest

from qmcbench import harness

BENCH = json.loads((harness.ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys():
    assert list(BENCH) == ['command', 'paths', 'run_seconds', 'configs', 'workloads',
                           'end_to_end', 'per_layer']
    assert BENCH['paths'] == ['qmcbench']
    assert all(not w.startswith('/') and '..' not in w for w in BENCH['command'])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    metrics = BENCH['end_to_end'] + BENCH['per_layer']
    names = [m['name'] for m in metrics] + CELLS + [c['name'] for c in BENCH['configs']]
    assert len(names) == len(set(names))
    for name in names + [w['traffic'] for w in BENCH['workloads']]:
        assert NAME.match(name), name
    for c in BENCH['configs']:
        assert all(NAME.match(k) for k in c['reduced'])
    for m in metrics:
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')


def test_run_seconds_fit_every_later_check():
    s = BENCH['run_seconds']
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')


@pytest.mark.parametrize('workload', CELLS)
def test_cell_resolves_to_its_files(workload):
    cell, cfg, traffic, limits = harness.cell_spec(workload, BENCH)
    assert cell['chips'] == 1
    assert cfg['name'] == cell['config'] and traffic['name'] == cell['traffic']
    entry = next(c for c in BENCH['configs'] if c['name'] == cell['config'])
    assert entry['file'].startswith('qmcbench/configs/')
    for key in entry['reduced']:
        assert key in cfg and key in cfg['published']
    kinds = {'loss_gap', 'grad_gap', 'update_gap'} if traffic['optimizer'] else set()
    assert set(limits) == kinds | {'eloc_rule', 'psi_rule'}
    e2e = [m for m in BENCH['end_to_end'] if workload in m.get('workloads', [workload])]
    per_layer = [m for m in BENCH['per_layer'] if workload in m.get('workloads', [workload])]
    assert 'setup_s' in [m['name'] for m in e2e] and len(e2e) >= 2 and per_layer
    for m in e2e + per_layer:
        assert callable(harness._reader(m['name']))
    moved = {m['name'] for m in e2e}
    assert all(m['moves'] in moved for m in per_layer)
