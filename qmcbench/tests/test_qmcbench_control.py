"""On the card: the control, the reference in float32 with TF32 put in the
program's place, and the program's own TF32 path, each fail the check at
the published widths on 512 walkers (the chip readings at the cells' own
size are in PERF.md)."""

import pytest

from qmcbench import control, harness

pytestmark = pytest.mark.chip


@pytest.mark.parametrize('workload', ['psiformer_h2o.train', 'psiformer_h2o.eval'])
def test_controls_fail(cuda, workload):
    cell, cfg, traffic, limits = harness.cell_spec(workload)
    traffic = dict(traffic, walkers=512)
    spec = (cell, cfg, traffic, limits)
    seconds = 0.0 if traffic['optimizer'] else 8.0
    low = control.readings(spec, 2**31 + 101, seconds, 'sound', cuda)['ref_tf32']
    assert any(low[k] > limit for k, limit in limits.items())
    tf32 = control.readings(spec, 2**31 + 103, seconds, 'tf32', cuda)['tf32']
    assert any(tf32[k] > limit for k, limit in limits.items())
