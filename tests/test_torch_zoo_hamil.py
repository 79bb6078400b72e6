"""The local energy and the Langevin force of the port's FermiNet and
``default`` ansätze against the JAX package.

E_loc and each of its terms (forward Laplacian, the flat log-determinant's
plain twin on the CPU) against JAX ``hamil.local_energy`` and against the
port's nested-autograd oracle (``physics.loop_laplacian``), at float64, the
small presets with JAX's parameters, the same walkers; relative 1e-9, the
tolerance of ``test_torch_hamil.py``.  Per-spin determinants on H2O and the Li
atom, full determinants on LiH's pinned walker, H2O and Li (FermiNet's
cases run in ``test_torch_zoo_hamil_ferminet.py``).  The ``default``
preset's Langevin force (autograd against ``jax.grad``, cleaned) to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_close,
    jax_model,
    jax_phys_conf,
    jit_once,
    torch_model,
    torch_phys_conf,
)
from torch_parity import walkers as draw_walkers

from deepqmc_tpu.sampling import electron_samplers as jax_samplers
from deepqmc_tpu_torch.physics import loop_laplacian
from deepqmc_tpu_torch.sampling import LangevinSampler

RTOL = 1e-9
TERMS = ('E_kin', 'V_loc', 'V_el', 'lap', 'quantum_force')
CASES = [('LiH', 'selfgolden', True), ('H2O', 'init_sample', True), ('Li', 'init_sample', True),
         ('H2O', 'init_sample', False), ('Li', 'init_sample', False)]


def make_case(preset, mol, source, full):
    """(model, JAX's parameters, walkers, JAX's E_loc and terms) of one case."""
    over = {'full_determinant': full}
    hamil_j, ansatz, params = jax_model(mol, seed=1, preset=preset, **over)
    r = draw_walkers(hamil_j, source, n=2, seed=3)
    eloc, stats = jit_once(jax.vmap(hamil_j.local_energy(ansatz.apply), (None, None, 0)))(
        None, params, jax_phys_conf(hamil_j, r)
    )
    want = {'E_loc': np.asarray(eloc), **{k: np.asarray(stats[f'hamil/{k}']) for k in TERMS}}
    return (preset, mol, over), params, r, want


# the ``default`` preset's cases; FermiNet's are in test_torch_zoo_hamil_ferminet.py
@pytest.fixture(scope='module', params=[('default', *c) for c in CASES],
                ids=lambda p: '-'.join(map(str, p)))
def case(request):
    return make_case(*request.param)


def _port(model, params, r, **hamil_kwargs):
    preset, mol, over = model
    hamil, wf = torch_model(mol, params, preset=preset, overrides=over, **hamil_kwargs)
    eloc, stats = hamil.local_energy(wf, torch_phys_conf(hamil, r))
    return {'E_loc': eloc.detach().numpy(),
            **{k: stats[f'hamil/{k}'].detach().numpy() for k in TERMS}}


def test_forward_laplacian_matches_jax(case):
    model, params, r, want = case
    with torch.inference_mode():
        got = _port(model, params, r)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=RTOL, err_msg=key)


def test_forward_laplacian_matches_autograd_oracle(case):
    model, params, r, _ = case
    with torch.inference_mode():
        got = _port(model, params, r)
    oracle = _port(model, params, r, laplacian_factory=loop_laplacian)
    for key, value in oracle.items():
        np.testing.assert_allclose(got[key], value, rtol=RTOL, err_msg=key)


@pytest.mark.parametrize('mol', ['LiH', 'Li'])
def test_langevin_force_of_default_matches_jax(mol, tau=0.1):
    """The cleaned force and psi of the ``default`` preset's walkers, as
    ``LangevinSampler.update`` gives them, and no ``.grad`` on the parameters."""
    hamil_j, ansatz, params = jax_model(mol, preset='default')
    hamil_t, wf = torch_model(mol, params, preset='default')
    r = draw_walkers(hamil_j, 'init_sample', n=8, seed=5)
    want = jit_once(jax_samplers.LangevinSampler(hamil_j, ansatz.apply, tau=tau).update)(
        {'r': jnp.asarray(r), 'age': jnp.zeros(len(r), jnp.int32), 'tau': jnp.asarray(tau)},
        params, jnp.asarray(hamil_j.mol.coords))
    with torch.no_grad():
        got = LangevinSampler(hamil_t, wf, tau=tau).update(
            {'r': torch.tensor(r), 'age': torch.zeros(len(r), dtype=torch.long),
             'tau': torch.tensor(tau, dtype=torch.float64)},
            torch.as_tensor(hamil_t.mol.coords))
    assert_close(got['force'], want['force'], 1e-10, 'force')
    np.testing.assert_array_equal(got['psi'].sign.numpy(), np.asarray(want['psi'].sign))
    assert_close(got['psi'].log, want['psi'].log, 1e-10, 'log psi')
    assert all(p.grad is None for p in wf.parameters())
