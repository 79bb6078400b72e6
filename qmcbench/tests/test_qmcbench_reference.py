"""The plain reference agrees with the port at float64 at a small width: the
wave function, the local energy, and three KFAC steps (loss, gradient,
parameters).  The test imports both; the reference imports neither."""

from functools import partial

import pytest
import torch

import deepqmc_tpu_torch as dq
from deepqmc_tpu_torch.kfac import KFAC
from deepqmc_tpu_torch.loss import create_loss_fn, median_clip_and_mask
from deepqmc_tpu_torch.types import PhysicalConfiguration
from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule
from qmcbench import check, harness
from qmcbench.reference import energy, kfac, nets
from qmcbench.tests.conftest import tiny_spec

CELLS = ['psiformer_h2o.train', 'ferminet_h2o.train']


def port_and_params(workload):
    _, cfg, traffic, _ = tiny_spec(workload)
    run = harness.Run(cfg, traffic, 7, 'cpu')
    m = cfg['molecule']
    mol = dq.Molecule(coords=m['coords'], charges=m['charges'], charge=m['charge'],
                      spin=m['spin'])
    hamil = dq.MolecularHamiltonian(mol=mol)
    widths = {k: cfg[k] for k in harness.WIDTH_KEYS[cfg['ansatz']]}
    wf = dq.ansatz_preset(cfg['ansatz'], **widths)(hamil)
    harness.draw_weights(wf, cfg['weights'], run.seed, 'cpu')
    wf = wf.double()
    R, Z = check.molecule(cfg, torch.float64, 'cpu')
    r = hamil.init_sample(torch.Generator().manual_seed(3), 12).r
    return cfg, traffic, hamil, wf, R, Z, r


def conf(R, r):
    return PhysicalConfiguration(R, r, torch.zeros(len(r), dtype=torch.long))


@pytest.mark.parametrize('workload', CELLS)
def test_psi_and_local_energy(workload):
    cfg, _, hamil, wf, R, Z, r = port_and_params(workload)
    P = {k: v.detach() for k, v in wf.state_dict().items()}
    with torch.no_grad():
        psi = wf(conf(R, r))
        E, _ = hamil.local_energy(wf, conf(R, r))
    sign, log = nets.log_psi(P, cfg, r, R)
    assert torch.equal(sign, psi.sign)
    torch.testing.assert_close(log, psi.log, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(energy.local_energy(P, cfg, r, R, Z), E, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize('workload', CELLS)
def test_kfac_steps(workload):
    cfg, traffic, hamil, wf, R, Z, r = port_and_params(workload)
    opt, clip = traffic['optimizer'], traffic['clip']
    ref = kfac.KFACReference(wf.state_dict(), cfg, R, Z, opt, clip)
    loss = create_loss_fn(hamil, wf, partial(median_clip_and_mask, clip_width=clip['width'],
                                             median_center=clip['median_center']))
    port = KFAC(loss, learning_rate_schedule=InverseSchedule(opt['learning_rate'],
                                                             opt['decay_rate']),
                damping_schedule=ConstantSchedule(opt['damping']),
                norm_constraint=opt['norm_constraint'],
                inverse_update_period=opt['inverse_update_period'])
    state = port.init(conf(R, r))
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        walkers = hamil.init_sample(gen, 12).r
        (value, _), grads, sums = loss.value_grad_and_taps(conf(R, walkers),
                                                           torch.ones(12, dtype=torch.float64))
        state, _ = port.update(state, grads, sums, 12)
        ref_value, _, _, ref_grads = ref.step(walkers)
        torch.testing.assert_close(value, ref_value, rtol=1e-9, atol=1e-9)
        for k, g in ref_grads.items():
            torch.testing.assert_close(grads[k], g, rtol=1e-7, atol=1e-7)
    for k, p in wf.state_dict().items():
        torch.testing.assert_close(p, ref.P[k], rtol=1e-9, atol=1e-9)
