"""A run at a tiny width on the CPU, with the harness's look for a card
skipped: the result line's keys, the readers, and the command's refusals."""

import json
import shutil
import subprocess
import sys

import pytest

from qmcbench import harness
from qmcbench.tests.conftest import tiny_spec

CELLS = ['psiformer_h2o.train', 'ferminet_h2o.train', 'psiformer_h2o.eval']
REQUIRED = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.mark.parametrize('workload', CELLS)
@pytest.mark.parametrize('trace', [0, 1])
def test_result_line(workload, trace):
    result, lines = harness.run_cell(workload, 2**31 + 11, 0.5, trace, 'cpu',
                                     spec=tiny_spec(workload))
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == REQUIRED and keys[-1] == 'checks'
    assert set(keys) == set(REQUIRED) | {'checks'} | ({'breakdown'} if trace else set())
    assert line['correct'] is True and line['failed'] == 0 and line['attempted'] >= 1
    assert line['device']['platform'] == 'cpu'
    assert all(set(c) == {'value', 'limit'} for c in line['checks'].values())
    assert lines[-1] == 'failed steps 0 limit 0'
    names = set(line['metrics'])
    if trace:
        assert {'busy_s', 'window_s'} <= set(line['device'])
        suffix = 'train' if 'train' in workload else 'eval'
        assert f'sampling_ms.{suffix}' in names and f'local_energy_ms.{suffix}' in names
        assert not any(n.startswith(('idle_share', 'fl_')) for n in names)  # no device trace
    else:
        assert 'setup_s' in names and 'peak_mem_gib' in names


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip('a card is present')
    out = subprocess.run([sys.executable, 'qmcbench/run.py', '--workload', CELLS[0],
                          '--seed', '1', '--seconds', '1', '--trace', '0'],
                         cwd=harness.ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and not out.stdout.strip()


def test_command_refuses_without_the_port(tmp_path):
    shutil.copy(harness.ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / 'qmcbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run([sys.executable, 'qmcbench/run.py', '--workload', CELLS[0],
                          '--seed', '1', '--seconds', '1', '--trace', '0'],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and not out.stdout.strip()
