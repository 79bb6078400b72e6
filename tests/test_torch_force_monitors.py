"""The port's force and position monitors against the JAX monitors, and
``task=evaluate_forces`` through the command line.

Each of the five ``ForceMonitor`` kinds over a ``[1, 2, 3]`` grid (one
molecule, two electronic states, three walkers a state), each state with
its own parameters, against ``deepqmc_tpu.observable.ForceMonitor`` at
float64 on the small PsiFormer cut to one layer (H2): the samples and their
walker mean and spread within 1e-8 (as ``test_torch_force.py``), the
zero-bias kinds fed the same local energies.  The position monitors'
samples.  Then the tiny H2 run of ``tests/test_torch_app.py`` and
``task=evaluate_forces`` from its checkpoint through ``app.cli``: with the
task's HDF5 sink the whitelisted ``hf_force_*`` keys in ``result.h5``, read
back by the port's ``postprocess``; with ``task.h5_logger=null``, as on the
card, the run ends and writes no file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, jax_model, jax_phys_conf, torch_model, walkers

from deepqmc_tpu import observable as jax_observable
from deepqmc_tpu.types import Psi as JaxPsi
from deepqmc_tpu_torch import app, observable
from deepqmc_tpu_torch.postprocess import read_and_convert_result
from deepqmc_tpu_torch.types import PhysicalConfiguration, Psi
from deepqmc_tpu_torch.wf import StateStack

RTOL = 1e-8
S, W = 2, 3
KINDS = ('bare', 'ac_zv', 'ac_zvq', 'ac_zvzb', 'ac_zvzbq')


@pytest.fixture(scope='module')
def grid():
    """Both packages' hamiltonian, per-state wave functions and parameters,
    and one batch's arguments of the ``[1, S, W]`` grid."""
    models = [jax_model('H2', seed=s, n_interactions=1) for s in (1, 2)]
    hamil_j, ansatz = models[0][:2]
    params = jax.tree_util.tree_map(lambda *x: np.stack(x), *(m[2] for m in models))
    ports = [torch_model('H2', m[2], overrides={'n_interactions': 1}) for m in models]
    stack = StateStack([wf for _, wf in ports])
    r = walkers(hamil_j, 'init_sample', n=S * W, seed=5).reshape(1, S, W, -1, 3)
    e_loc = -1.1 + 0.1 * np.random.default_rng(0).normal(size=(1, S, W))
    pc_j = jax.tree_util.tree_map(lambda x: x.reshape(1, S, W, *x.shape[1:]),
                                  jax_phys_conf(hamil_j, r.reshape(S * W, -1, 3)))
    jax_args = (params, pc_j, JaxPsi(jnp.ones((1, S, W)), jnp.zeros((1, S, W))),
                jnp.asarray(e_loc), None)
    R = torch.as_tensor(hamil_j.mol.coords)[None]
    pc_t = PhysicalConfiguration(R, torch.tensor(r), torch.zeros(1, S, W, dtype=torch.long))
    port_args = (None, pc_t, Psi(torch.ones(1, S, W), torch.zeros(1, S, W)),
                 torch.tensor(e_loc), None)
    return hamil_j, ansatz, ports[0][0], stack, jax_args, port_args


def _run(monitor_cls, args, hamil, wf, *cls_args):
    return monitor_cls(*cls_args, save_samples=True, period=1).finalize(hamil, wf)(0, *args)


@pytest.mark.parametrize('kind', KINDS)
def test_force_monitor_matches_jax(grid, kind):
    hamil_j, ansatz, hamil_t, stack, jax_args, port_args = grid
    want = _run(jax_observable.ForceMonitor, jax_args, hamil_j, ansatz.apply, kind)
    got = _run(observable.ForceMonitor, port_args, hamil_t, stack, kind)
    assert set(got) == set(want) == {f'hf_force_{kind}/{k}' for k in ('mean', 'std', 'samples')}
    assert got[f'hf_force_{kind}/samples'].shape == (1, S, W, 2, 3)
    for key, value in want.items():
        assert_close(got[key], value, RTOL, key)


def test_force_monitor_aliases_and_kinds():
    for alias, kind in (('BareForceMonitor', 'bare'), ('ACZVForceMonitor', 'ac_zv'),
                        ('ACZVZBForceMonitor', 'ac_zvzb'), ('ACZVQForceMonitor', 'ac_zvq'),
                        ('ACZVZBQForceMonitor', 'ac_zvzbq')):
        monitor = getattr(observable, alias)(save_samples=False, period=2)
        assert (monitor.kind, monitor.name, monitor.period) == (kind, f'hf_force_{kind}', 2)
    with pytest.raises(ValueError, match='unknown force estimator'):
        observable.ForceMonitor('ac_zz', save_samples=False, period=1)


@pytest.mark.parametrize('name', ['ElectronPositionMonitor', 'NuclearPositionMonitor'])
def test_position_monitors_match_jax(grid, name):
    hamil_j, ansatz, hamil_t, stack, jax_args, port_args = grid
    want = _run(getattr(jax_observable, name), jax_args, hamil_j, ansatz.apply)
    got = _run(getattr(observable, name), port_args, hamil_t, stack)
    assert set(got) == set(want) and len(want) == 1
    for key, value in want.items():
        assert_close(got[key], value, 0.0, key)


TINY = ['hamil/mol=H2', 'task.steps=1', 'task.electron_batch_size=8', '+task.max_eq_steps=1',
        'task.pretrain_steps=null', 'task/opt=adamw', 'ansatz.n_determinants=2',
        'ansatz.omni_factory.embedding_dim=16', 'ansatz.omni_factory.gnn_factory.n_interactions=1',
        'task.metric_logger_constructor=null', 'task.h5_logger_constructor=null']


def test_evaluate_forces_from_the_command_line(tmp_path):
    pytest.importorskip('h5py')
    run = tmp_path / 'run'
    app.cli(['--device=cpu', *TINY, f'--workdir={run}'])
    app.cli(['--device=cpu', 'task=evaluate_forces', f'task.restdir={run / "training"}',
             '+task.steps=2', f'--workdir={tmp_path / "forces"}'])
    log = (tmp_path / 'forces' / 'deepqmc.log').read_text()
    assert 'The evaluation has been completed!' in log
    assert len([line for line in log.splitlines() if 'evaluation step' in line]) == 2
    kinds = ('ac_zvq', 'ac_zv', 'ac_zvzbq', 'ac_zvzb')
    keys = [f'hf_force_{k}/{s}' for k in kinds for s in ('samples', 'mean')]
    results = read_and_convert_result(tmp_path / 'forces', *keys)
    assert set(results) == set(keys)
    for kind in kinds:
        samples = results[f'hf_force_{kind}/samples']
        assert samples.shape == (2, 1, 1, 8, 2, 3)  # [step, molecule, state, walker, M, 3]
        assert np.isfinite(samples).all()
        assert_close(results[f'hf_force_{kind}/mean'], samples.mean(-3), 1e-6, kind)

    app.cli(['--device=cpu', 'task=evaluate_forces', f'task.restdir={run / "training"}',
             '+task.steps=1', 'task.h5_logger=null', f'--workdir={tmp_path / "card"}'])
    assert not (tmp_path / 'card' / 'evaluation' / 'result.h5').exists()
    assert 'The evaluation has been completed!' in (tmp_path / 'card' / 'deepqmc.log').read_text()
