"""The check sees faults in the timed path: a tiny run on the CPU with the
program broken underneath (the faults of ``control.py``) comes out not
correct, each fault in each cell that can have it."""

import pytest

from qmcbench import control, harness
from qmcbench.tests.conftest import tiny_spec

CASES = [(cell, fault) for cell in ('psiformer_h2o.train', 'ferminet_h2o.train')
         for fault in ('half_batch', 'altered', 'frozen')] + [('psiformer_h2o.eval', 'altered')]


@pytest.mark.parametrize('workload,fault', CASES)
def test_fault_is_not_correct(workload, fault):
    with control.FAULTS[fault]():
        result, _ = harness.run_cell(workload, 2**33 + 5, 0.5, 0, 'cpu',
                                     spec=tiny_spec(workload))
    assert result['correct'] is False
    assert any(c['value'] > c['limit'] for c in result['checks'].values())
