"""The port's offline ECP tools against the JAX package's.

``deepqmc_tpu_torch/ecp/radial_atom.py`` (the exchange-only LDA radial atom,
all-electron or with a Gaussian ECP from the port's tables) and
``ecp/fit.py`` (the least-squares refit of an ECP's free parameters) are held
to ``deepqmc_tpu/ecp/radial_atom.py`` and ``deepqmc_tpu/ecp/fit.py`` on the
same inputs, both numpy float64, at relative tolerance 1e-10, on small grids.
The port forms the channel solver's shift-invert operator densely where the
JAX package runs scipy's sparse Lanczos on the same operator: the same
eigenpairs to float64 rounding (about 1e-13 of the eigenvalues), which the
self-consistent loop keeps well below 1e-10.  The port's ECP modules do not
import scipy, so ``fit_ecp_params`` takes the least-squares solver as an
argument (a numpy Levenberg-Marquardt by default); held to the JAX fit at
1e-10 it is given scipy's, as JAX's calls it, both cut to the same number of
evaluations (scipy counts the Jacobian's apart).  The port's own solver is
held to lower the fit's cost, and run to its end against the JAX fit run to
scipy's: the two stop at different points of the minimum's floor, which the
self-consistent solves blur, so they agree to that blur, not to 1e-10.
"""

import copy
import functools

import numpy as np
import pytest
import scipy.optimize
from threadpoolctl import threadpool_limits

from deepqmc_tpu.ecp import fit as jax_fit
from deepqmc_tpu.ecp import radial_atom as jax_atom
from deepqmc_tpu.ecp.data import get_ecp_params as jax_ecp_params
from deepqmc_tpu_torch.ecp import fit, radial_atom
from deepqmc_tpu_torch.ecp.data import get_ecp_params

RTOL = 1e-10
GRID = {'rmin': 1e-5, 'rmax': 40.0, 'n_grid': 160}
FIT_GRID = {'rmin': 1e-5, 'rmax': 40.0, 'n_grid': 100}  # a fit solves the atom some 20 times
# The fit's residuals (Ha) come from self-consistent solves stopped at |dE| <
# 1e-9 and warm-started from the last converged density, so the same theta
# gives residuals that differ by up to about 5e-7 Ha between two evaluations
# (the carbon problem below, read near its minimum): two solvers stopped at
# that floor agree to a few times it.  The flattest direction of the
# objective is held only by the tether (0.03 of each theta's move), so their
# theta agree to the residuals' bar over 0.03.
FIT_RES_ATOL = 2e-6
FIT_THETA_ATOL = FIT_RES_ATOL / 0.03


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """The dense solves take one BLAS thread, as each pytest worker should."""
    with threadpool_limits(limits=1):
        yield


def _same_solution(got, want):
    assert got.converged == want.converged and got.iterations == want.iterations
    np.testing.assert_allclose(got.e_total, want.e_total, rtol=RTOL)
    assert got.eigenvalues.keys() == want.eigenvalues.keys()
    for k, eps in want.eigenvalues.items():
        np.testing.assert_allclose(got.eigenvalues[k], eps, rtol=RTOL)
        # an eigenvector's sign is arbitrary
        np.testing.assert_allclose(np.abs(got.orbitals[k]), np.abs(want.orbitals[k]),
                                   rtol=0, atol=1e-8)
    for k, v in want.e_components.items():
        np.testing.assert_allclose(got.e_components[k], v, rtol=RTOL)


def test_port_tables_are_the_jax_tables():
    for z in (3, 6, 7, 8, 21):
        assert get_ecp_params('ccECP', z) == jax_ecp_params('ccECP', z)


def test_channel_potentials_match():
    r = np.linspace(0.05, 4.0, 23)
    for z in (6, 21):
        got = radial_atom.ecp_channel_potentials(r, z, get_ecp_params('ccECP', z))
        want = jax_atom.ecp_channel_potentials(r, z, jax_ecp_params('ccECP', z))
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
        assert len(got[1]) == len(want[1]) and got[2] == want[2]
        for u, w in zip(got[1], want[1]):
            np.testing.assert_allclose(u, w, rtol=RTOL, atol=1e-300)


def test_channel_solver_matches_on_hydrogenic_spectra():
    h, r = jax_atom._log_grid(1e-6, 50.0, 400)
    for z, l in ((1, 0), (8, 1), (3, 2)):
        eps, u = radial_atom._solve_channel(h, r, l, -z / r, 3)
        eps_j, u_j = jax_atom._solve_channel(h, r, l, -z / r, 3)
        np.testing.assert_allclose(eps, eps_j, rtol=RTOL)
        np.testing.assert_allclose(np.abs(u), np.abs(u_j), rtol=0, atol=1e-9)


@pytest.mark.parametrize('case', ['all_electron', 'ccECP', 'ionized_valence'])
def test_solve_atom_matches(case):
    if case == 'all_electron':
        args, kwargs = (6, {0: [2, 2], 1: [2]}), {}
    elif case == 'ccECP':
        args, kwargs = (6, {0: [2], 1: [2]}), {'ecp_params': get_ecp_params('ccECP', 6)}
    else:  # no valence electron left (Li+ under its He-core ECP)
        args, kwargs = (3, {}), {'ecp_params': get_ecp_params('ccECP', 3)}
    got = radial_atom.solve_atom(*args, **kwargs, **GRID)
    want = jax_atom.solve_atom(*args, **kwargs, **GRID)
    _same_solution(got, want)


def test_solve_atom_spin_matches():
    got, (up, down) = radial_atom.solve_atom_spin(7, {0: [1, 1], 1: [3]}, {0: [1, 1]}, **GRID)
    want, (up_j, down_j) = jax_atom.solve_atom_spin(7, {0: [1, 1], 1: [3]}, {0: [1, 1]},
                                                    **GRID)
    _same_solution(got, want)
    for a, b in ((up, up_j), (down, down_j)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL)
    assert up[(0, 1)] < down[(0, 1)]  # exchange stabilizes the majority spin


@pytest.fixture(scope='module')
def fit_problem():
    """A perturbed carbon ccECP and its all-electron targets (the JAX
    package's recovery check, on a small grid)."""
    params = copy.deepcopy(get_ecp_params('ccECP', 6))
    params[2][0][0][1] *= 1.3
    ae = jax_atom.solve_atom(6, {0: [2, 2], 1: [2]}, **FIT_GRID)
    ion = jax_atom.solve_atom(6, {0: [2, 2], 1: [1]}, **FIT_GRID)
    eig = {(0, 0): ae.eigenvalues[(0, 1)], (1, 0): ae.eigenvalues[(1, 0)]}
    probes = [({0: [2], 1: [1]}, ion.e_total - ae.e_total)]
    return params, {0: [2], 1: [2]}, eig, probes


def test_pack_and_unpack_match(fit_problem):
    params = fit_problem[0]
    theta = fit.pack_params(params[1], params[2])
    np.testing.assert_array_equal(theta, jax_fit.pack_params(params[1], params[2]))
    assert fit.unpack_params(theta, 4, 1, [1]) == jax_fit.unpack_params(theta, 4, 1, [1])


def test_fit_matches_with_the_same_solver(monkeypatch, fit_problem):
    short = functools.partial(scipy.optimize.least_squares, max_nfev=2)
    monkeypatch.setattr(scipy.optimize, 'least_squares', short)
    want, res_j = jax_fit.fit_ecp_params(6, *fit_problem, grid_kwargs=FIT_GRID)
    got, res = fit.fit_ecp_params(6, *fit_problem, grid_kwargs=FIT_GRID, solver=short)
    np.testing.assert_allclose(fit.pack_params(got[1], got[2]),
                               fit.pack_params(want[1], want[2]), rtol=RTOL)
    # differences of energies of order 1 Ha: 1e-10 of that, absolute
    np.testing.assert_allclose(res, res_j, rtol=RTOL, atol=RTOL)


def test_port_solver_lowers_the_cost(fit_problem):
    params, occs, eig, probes = fit_problem
    solver = functools.partial(fit.least_squares, max_nfev=10)
    fitted, res = fit.fit_ecp_params(6, *fit_problem, grid_kwargs=FIT_GRID, solver=solver)
    start = radial_atom.solve_atom(6, occs, ecp_params=params, **FIT_GRID)
    res0 = [start.eigenvalues[k] - v for k, v in eig.items()]
    for occs_after, d_ae in probes:
        probe = radial_atom.solve_atom(6, occs_after, ecp_params=params, **FIT_GRID)
        res0.append(probe.e_total - start.e_total - d_ae)
    assert np.all(np.isfinite(res)) and np.sum(np.square(res)) < np.sum(np.square(res0))


def test_port_solver_converges_to_the_jax_fit(fit_problem):
    """The port's own solver and the JAX fit's scipy ``least_squares``, each
    run to its stopping criteria, reach the same parameters and residuals."""
    want, res_j = jax_fit.fit_ecp_params(6, *fit_problem, grid_kwargs=FIT_GRID)
    got, res = fit.fit_ecp_params(6, *fit_problem, grid_kwargs=FIT_GRID)
    theta, theta_j = (fit.pack_params(p[1], p[2]) for p in (got, want))
    start = fit.pack_params(fit_problem[0][1], fit_problem[0][2])
    assert np.abs(theta_j - start).max() > 100 * FIT_THETA_ATOL  # the fit moved theta
    np.testing.assert_allclose(theta, theta_j, rtol=0, atol=FIT_THETA_ATOL)
    np.testing.assert_allclose(res, res_j, rtol=0, atol=FIT_RES_ATOL)
