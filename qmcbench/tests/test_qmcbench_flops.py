"""The yardstick's counts: the forward's products equal what
``torch.utils.flop_counter.FlopCounterMode`` counts over the reference's
forward, and its dense layers are the reference's."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from qmcbench import check, flops
from qmcbench.reference import nets
from qmcbench.tests.conftest import tiny_spec

CELLS = ['psiformer_h2o.train', 'ferminet_h2o.train']


def random_params(cfg, R):
    """Parameters of the reference's shapes from the yardstick's dense layers."""
    gen = torch.Generator().manual_seed(0)
    P = {}
    for name, i, o, bias, _ in flops.dense_layers(cfg):
        P[name + '.w'] = torch.randn(i, o, generator=gen, dtype=R.dtype) / i**0.5
        if bias:
            P[name + '.b'] = torch.randn(o, generator=gen, dtype=R.dtype) / o**0.5
    n_orb = cfg['n_determinants'] * (cfg['n_up'] + cfg['n_down'])
    for spin in ('up', 'down'):
        P[f'envelope.pi_{spin}'] = torch.ones(n_orb, len(R), dtype=R.dtype)
        P[f'envelope.zetas_{spin}'] = torch.ones(n_orb, len(R), dtype=R.dtype)
    P['cusp_electrons.same_alpha'] = P['cusp_electrons.anti_alpha'] = torch.tensor(1.0).to(R)
    return P


@pytest.mark.parametrize('workload', CELLS)
@pytest.mark.parametrize('walkers', [1, 7])
def test_forward_count(workload, walkers):
    _, cfg, _, _ = tiny_spec(workload)
    R, _ = check.molecule(cfg, torch.float64, 'cpu')
    P = random_params(cfg, R)
    r = torch.randn(walkers, cfg['n_up'] + cfg['n_down'], 3, dtype=torch.float64)
    with FlopCounterMode(display=False) as counter:
        nets.log_psi(P, cfg, r, R)
    assert counter.get_total_flops() == flops.forward_flops(cfg, walkers)
    rows = nets.dense_names(P, cfg, R)
    assert rows == {name: n for name, *_, n in flops.dense_layers(cfg)}


def test_psiformer_step_count_at_the_published_widths():
    """About 9 TFLOP a fit step of 4096 walkers (30 moves): 4.2 sampling,
    4.5 the forward Laplacian, 0.5 the backward and KFAC."""
    from qmcbench import harness

    _, cfg, traffic, _ = harness.cell_spec('psiformer_h2o.train')
    assert 8.5e12 < flops.step_flops(cfg, traffic) < 10e12


def test_rooflines_cannot_pass_100_percent_by_the_peak():
    """A bound at 165 TFLOP/s is never above the one at the SIMT 67."""
    _, nbytes, ops = flops.attention_bound(4096)
    assert flops.roofline_s(nbytes, ops) >= ops / flops.PEAKS['f32_flops_per_s']
    assert flops.PEAKS['f32_flops_per_s'] > flops.PEAKS['f32_simt_flops_per_s']
