"""Refit Gaussian ECP parameters against all-electron valence physics.

The port's copy of ``deepqmc_tpu/ecp/fit.py``, numpy only.  Companion to
:mod:`.radial_atom`: when a table fails the AE-vs-ECP valence check and no
external oracle exists offline, the free Gaussian parameters are
re-optimized so the ECP atom reproduces the all-electron exchange-only-LDA
valence spectrum and ionization-like total-energy differences.  The result
is an in-house, LDA-consistent potential (the JAX package's refits behind
``DEEPQMC_TPU_ECP_USE_REFIT``, which ``ecp/data.py`` reads).

Constrained structure (the ccECP functional form):

- local r^-1 class: single term, coefficient pinned to Z_eff (cancels the
  -Z_eff/r divergence at the origin),
- local r^1 class: coefficient pinned to Z_eff * alpha(r^-1) (cancels the
  O(r) slope at the origin; the published tables obey this identity),
- everything else (exponents, the r^0 term, projector terms) free, with
  exponents parameterized in log space for positivity.

The fit is a damped least-squares over valence eigenvalue deviations and
Delta-E probe deviations, with a weak tether to the initial parameters so
under-determined directions stay near the published-structure starting
point.  The JAX package minimises with scipy's ``least_squares``, which the
port's ECP modules do not import: :func:`least_squares` here is a
Levenberg-Marquardt of the same objective on the same forward-difference
Jacobian, with tolerances of the same names; a caller may pass scipy's.
"""

from types import SimpleNamespace

import numpy as np

from .radial_atom import solve_atom

__all__ = ['fit_ecp_params', 'least_squares', 'pack_params', 'unpack_params']


def pack_params(local, nonlocal_):
    """Free-parameter vector theta from registry-layout ECP parameters."""
    (a_coul, _), = local[0]  # single r^-1 term; beta pinned to Z_eff
    (a_lin, _), = local[2]  # single r^1 term; beta pinned to Z_eff * a_coul
    theta = [np.log(a_coul), np.log(a_lin)]
    for alpha, beta in local[1]:
        theta += [np.log(alpha), beta]
    for chan in nonlocal_:
        for alpha, beta in chan:
            theta += [np.log(alpha), beta]
    return np.asarray(theta)


def unpack_params(theta, z_eff, n_const_terms, n_chan_terms):
    """Registry-layout (local, nonlocal) from the free-parameter vector."""
    a_coul, a_lin = np.exp(theta[0]), np.exp(theta[1])
    local = [[[a_coul, float(z_eff)]], [], [[a_lin, float(z_eff) * a_coul]]]
    i = 2
    for _ in range(n_const_terms):
        local[1].append([np.exp(theta[i]), theta[i + 1]])
        i += 2
    nonlocal_ = []
    for n_terms in n_chan_terms:
        chan = []
        for _ in range(n_terms):
            chan.append([np.exp(theta[i]), theta[i + 1]])
            i += 2
        nonlocal_.append(chan)
    return local, nonlocal_


def _jacobian(fun, x, f0, diff_step):
    """Forward differences of ``fun`` at ``x``, each step ``diff_step``
    max(1, |x_i|) with the sign of x_i, as scipy's ``approx_derivative``."""
    jac = np.empty((len(f0), len(x)))
    for i in range(len(x)):
        step = diff_step * (1.0 if x[i] >= 0 else -1.0) * max(1.0, abs(x[i]))
        xs = x.copy()
        xs[i] += step
        jac[:, i] = (fun(xs) - f0) / (xs[i] - x[i])
    return jac


def least_squares(fun, x0, diff_step=1e-3, ftol=1e-12, xtol=1e-10, max_nfev=None, **_):
    """Minimise 0.5 |fun(x)|^2 by Levenberg-Marquardt on the forward-difference
    Jacobian, the variables scaled by its column norms (scipy's ``x_scale=
    'jac'``); stops, as scipy's ``check_termination`` does, when an accepted
    step lowers the cost by less than ``ftol`` of it, or when a step, taken or
    refused, moves x by less than ``xtol`` of |x|: the residuals come from
    self-consistent solves stopped at their own tolerance, so near the minimum
    no step lowers the cost and the damping grows until the step vanishes.
    Returns ``.x``, ``.fun``, ``.nfev``."""
    x = np.asarray(x0, dtype=float).copy()
    f = np.asarray(fun(x), dtype=float)
    nfev, lam = 1, 1e-3
    max_nfev = max_nfev or 100 * len(x)
    done = False
    while nfev < max_nfev and not done:
        jac = _jacobian(fun, x, f, diff_step)
        nfev += len(x)
        scale = np.maximum(np.linalg.norm(jac, axis=0), 1e-12)
        js = jac / scale
        grad, jtj = js.T @ f, js.T @ js
        cost = 0.5 * f @ f
        while nfev < max_nfev:
            ds = np.linalg.solve(jtj + lam * np.diag(np.diag(jtj) + 1e-12), -grad)
            dx = ds / scale
            done = np.linalg.norm(dx) <= xtol * (xtol + np.linalg.norm(x))
            f_new = np.asarray(fun(x + dx), dtype=float)
            nfev += 1
            cost_new = 0.5 * f_new @ f_new
            if cost_new < cost:
                lam = max(lam / 3.0, 1e-12)
                x, f = x + dx, f_new
                done = done or cost - cost_new <= ftol * cost
                break
            lam *= 4.0
            if done:
                break
    return SimpleNamespace(x=x, fun=f, nfev=nfev)


def fit_ecp_params(
    z,
    init_params,
    val_occs,
    eig_targets,
    probe_targets,
    grid_kwargs=None,
    tether=0.03,
    verbose=False,
    solver=least_squares,
):
    """Least-squares refit of the free Gaussian parameters.

    ``eig_targets``: {(l, n_valence): eps_ae}; ``probe_targets``:
    [(occs_after_probe, delta_e_ae)].  Returns (params, final_residuals)
    with params in registry layout (n_core, local, nonlocal).  ``solver``
    takes scipy's ``least_squares`` signature (the JAX package calls scipy's).
    """
    n_core, local0, nonlocal0 = init_params
    z_eff = z - n_core
    n_const = len(local0[1])
    n_chan = [len(c) for c in nonlocal0]
    theta0 = pack_params(local0, nonlocal0)
    grid_kwargs = grid_kwargs or {'n_grid': 1100, 'rmin': 1e-5}
    warm = {}  # occupation signature -> converged density (warm starts)

    def _solve(occs, params):
        key = tuple(sorted((l, tuple(fs)) for l, fs in occs.items()))
        sol = solve_atom(
            z, occs, ecp_params=params, p_init=warm.get(key), **grid_kwargs
        )
        if sol.converged and sol.p_density is not None:
            warm[key] = sol.p_density
        return sol

    def residuals(theta):
        local, nonlocal_ = unpack_params(theta, z_eff, n_const, n_chan)
        params = (n_core, local, nonlocal_)
        base = _solve(val_occs, params)
        converged = bool(base.converged)
        res = [base.eigenvalues[k] - v for k, v in eig_targets.items()]
        for occs_after, d_ae in probe_targets:
            probe = _solve(occs_after, params)
            converged = converged and bool(probe.converged)
            res.append((probe.e_total - base.e_total) - d_ae)
        res.extend(tether * (theta - theta0))
        if not (converged and all(np.isfinite(res))):
            # theta-dependent penalty: a constant vector has a zero
            # finite-difference Jacobian, which stalls least_squares at the
            # infeasible point; growing with |theta - theta0| pushes it back
            res = [1e3 * (1.0 + float(np.linalg.norm(theta - theta0)))] * len(res)
        if verbose:
            devs = ', '.join(f'{r * 1e3:+.1f}' for r in res[: -len(theta0)])
            print(f'  devs [mHa]: {devs}', flush=True)
        return np.asarray(res)

    fit = solver(
        residuals, theta0, diff_step=1e-3, x_scale='jac', ftol=1e-12, xtol=1e-10
    )
    local, nonlocal_ = unpack_params(fit.x, z_eff, n_const, n_chan)
    return (n_core, local, nonlocal_), fit.fun[: len(eig_targets) + len(probe_targets)]
