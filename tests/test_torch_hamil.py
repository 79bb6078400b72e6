"""The port's forward-Laplacian local energy against the JAX package.

E_loc and each of its terms from ``deepqmc_tpu_torch`` (forward Laplacian,
plain kernels on the CPU) against JAX ``hamil.local_energy`` (its forward
Laplacian on the CPU) and against the port's nested-autograd oracle
(``physics.loop_laplacian``), at float64, small PsiFormer, same parameters
and walkers; closed-shell LiH and H2O, the open-shell Li atom (2 up, 1 down)
and triplet H2 (no down electron).  Relative tolerance 1e-9: the Laplacian sums 3N second
derivatives, each a long chain of products through attention, determinant
inverses and the softmax, so float64 rounding accumulates to well above 1e-12
but stays far below 1e-9 of the terms' scale.
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import jax_model, jax_phys_conf, jit_once, torch_model, torch_phys_conf, walkers

from deepqmc_tpu_torch.physics import loop_laplacian

RTOL = 1e-9
TERMS = ('E_kin', 'V_loc', 'V_el', 'lap', 'quantum_force')


@pytest.fixture(scope='module', params=[('LiH', 'selfgolden'), ('H2O', 'init_sample'),
                                        ('Li', 'init_sample'), ('H2_triplet', 'init_sample')])
def case(request):
    mol, source = request.param
    hamil_j, ansatz, params = jax_model(mol, seed=1)
    r = walkers(hamil_j, source, n=2, seed=3)
    eloc, stats = jit_once(jax.vmap(hamil_j.local_energy(ansatz.apply), (None, None, 0)))(
        None, params, jax_phys_conf(hamil_j, r)
    )
    want = {'E_loc': np.asarray(eloc), **{k: np.asarray(stats[f'hamil/{k}']) for k in TERMS}}
    return mol, params, r, want


def _port(mol, params, r, **hamil_kwargs):
    hamil, wf = torch_model(mol, params, **hamil_kwargs)
    pc = torch_phys_conf(hamil, r)
    eloc, stats = hamil.local_energy(wf, pc)
    return {'E_loc': eloc.detach().numpy(),
            **{k: stats[f'hamil/{k}'].detach().numpy() for k in TERMS}}


def test_forward_laplacian_matches_jax(case):
    mol, params, r, want = case
    with torch.inference_mode():
        got = _port(mol, params, r)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=RTOL, err_msg=key)


def test_forward_laplacian_matches_autograd_oracle(case):
    mol, params, r, _ = case
    with torch.inference_mode():
        got = _port(mol, params, r)
    oracle = _port(mol, params, r, laplacian_factory=loop_laplacian)
    for key, value in oracle.items():
        np.testing.assert_allclose(got[key], value, rtol=RTOL, err_msg=key)


def test_nuclear_energy_and_potentials_by_hand():
    """E_nn, V_el and V_loc of one H2O walker against explicit sums."""
    import deepqmc_tpu_torch as dqt
    from deepqmc_tpu_torch import physics

    mol = dqt.Molecule.from_name('H2O')
    R = torch.as_tensor(mol.coords)
    Z = torch.as_tensor(mol.charges)
    r = torch.as_tensor(np.random.default_rng(0).normal(size=(1, 10, 3)))
    e_nn = sum(Z[i] * Z[j] / (R[i] - R[j]).norm() for i in range(3) for j in range(i + 1, 3))
    v_el = sum(1 / (r[0, i] - r[0, j]).norm() for i in range(10) for j in range(i + 1, 10))
    v_loc = -sum(Z[a] / (r[0, i] - R[a]).norm() for i in range(10) for a in range(3))
    torch.testing.assert_close(physics.nuclear_energy(R, Z), e_nn, rtol=1e-12, atol=0)
    torch.testing.assert_close(physics.electronic_potential(r)[0], v_el, rtol=1e-12, atol=0)
    torch.testing.assert_close(physics.nuclear_potential(r, R, Z)[0], v_loc, rtol=1e-12, atol=0)
