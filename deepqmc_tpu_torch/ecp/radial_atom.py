"""Radial atomic mean-field solver for ECP transferability validation.

The port's copy of ``deepqmc_tpu/ecp/radial_atom.py``, numpy only: the
offline oracle for the ECP tables (``ecp/data.py``).  It solves the
spherically averaged exchange-only LDA (Slater/Dirac exchange) atom on a
logarithmic radial grid, either all-electron or with a Gaussian-type
semi-local ECP (the functional form of :class:`~.GaussianTypeECP`), so AE and
ECP runs of identical configurations can be compared shell by shell:

- valence eigenvalues eps_nl (AE) vs eps_nl (ECP),
- total-energy differences between occupation patterns (ionization-like
  Delta-E probes), which cancel the core energy exactly.

Method notes.  Radial Schroedinger equation for u(r) = r R(r) on a log grid
x = ln r: substituting u = sqrt(r) v yields the generalized symmetric
eigenproblem  [-1/2 d^2/dx^2 + 1/8 + l(l+1)/2 + r^2 V(r)] v = eps r^2 v.
Exchange-only LDA is local (no Slater-integral angular algebra),
deterministic, and equally diagnostic for AE-vs-ECP *differences*;
fractional per-channel occupations give the spherically averaged atom, which
handles open d shells (Sc 4s^2 3d^1) without multiplet machinery.

The JAX package solves a channel by sparse shift-invert Lanczos (scipy),
which the port's ECP modules do not import; here the same shift-invert
operator is formed densely (:func:`_solve_channel`): the same eigenpairs to
float64 rounding, at O(n_grid^3) a channel solve.
"""

from dataclasses import dataclass, field

import numpy as np

__all__ = ['AtomSolution', 'ecp_channel_potentials', 'solve_atom', 'solve_atom_spin']

_CX = -(3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0)  # Dirac exchange constant


@dataclass
class AtomSolution:
    e_total: float
    eigenvalues: dict  # (l, n) -> eps  with n counting from 0 within channel
    orbitals: dict  # (l, n) -> u(r) on the grid, normalized: int u^2 dr = 1
    r: np.ndarray
    occs: dict  # l -> list of occupation numbers
    iterations: int
    converged: bool
    e_components: dict = field(default_factory=dict)
    p_density: np.ndarray = None  # radial density, for SCF warm starts


def _log_grid(rmin, rmax, n):
    x = np.linspace(np.log(rmin), np.log(rmax), n)
    return x[1] - x[0], np.exp(x)


def ecp_channel_potentials(r, z, ecp_params):
    """(V_local(r), [U_l(r)...], z_valence) for Gaussian ECP parameters.

    ``ecp_params`` is the registry layout of :mod:`.data` (``get_ecp_params``):
    (n_core, local, nonlocal) with local = three [alpha, beta] lists for the
    r^-1 / r^0 / r^1 Gaussian classes.  Matches the local potential of
    :class:`~.GaussianTypeECP` evaluated for a single nucleus.
    """
    n_core, local, nonlocal_ = ecp_params
    z_val = z - n_core
    v_loc = -z_val / r
    for cls, radial in zip(local, (1.0 / r, np.ones_like(r), r)):
        for alpha, beta in cls:
            v_loc = v_loc + beta * radial * np.exp(-alpha * r**2)
    u_l = []
    for chan in nonlocal_:
        u = np.zeros_like(r)
        for alpha, beta in chan:
            u = u + beta * np.exp(-alpha * r**2)
        u_l.append(u)
    return v_loc, u_l, z_val


def _solve_channel(h, r, l, v_eff, n_states):
    """Lowest ``n_states`` of one angular-momentum channel.

    Generalized pentadiagonal eigenproblem A v = eps B v (A = -1/2 D2 +
    diag(1/8 + l(l+1)/2 + r^2 V) with a 4th-order D2 stencil, B = diag(r^2)),
    by shift-invert with the shift sigma below the spectrum, as the JAX
    package's Lanczos: with A - sigma B = G G^T (positive definite) and
    B = R R (R = diag(r)), the eigenvalues of S = (G^-1 R)^T (G^-1 R) are
    1 / (eps - sigma), the largest first, and S never divides by r^2 (the
    standard form's 1 / (h rmin)^2 norm would drown the valence eigenvalues).
    Each eigenvector y of S gives v = (A - sigma B)^-1 R y, one step of
    inverse iteration.
    """
    n = len(r)
    inv12h2 = 1.0 / (12.0 * h**2)
    q = 0.125 + l * (l + 1) / 2.0 + r**2 * v_eff
    a = np.diag(30.0 * inv12h2 * 0.5 + q)
    for k, c in ((1, -16.0 * inv12h2 * 0.5), (2, 1.0 * inv12h2 * 0.5)):
        a += np.diag(np.full(n - k, c), k) + np.diag(np.full(n - k, c), -k)
    # rigorous-ish lower bound on the spectrum: split off the strongest
    # Coulomb tail (T - zmax/r >= -zmax^2/2); the remainder is bounded below
    zmax = max(0.0, float(-(v_eff * r).min()))
    v_remainder = v_eff + zmax / r
    sigma = -0.55 * zmax**2 + min(0.0, float(v_remainder.min())) - 10.0
    g = np.linalg.cholesky(a - sigma * np.diag(r**2))
    w = np.linalg.solve(g, np.diag(r))  # G^-1 R
    mu, y = np.linalg.eigh(w.T @ w)
    mu, y = mu[::-1][:n_states], y[:, ::-1][:, :n_states]
    eps = sigma + 1.0 / mu
    v = np.linalg.solve(g.T, w @ y)  # (A - sigma B)^-1 R y, up to a factor
    u = np.sqrt(r)[:, None] * v
    u = u / np.sqrt((u**2 * r[:, None]).sum(axis=0) * h)  # int u^2 dr = 1
    return eps, u


def _hartree(h, r, p_density):
    """V_H(r) from the radial density P(r) = sum_nl f u^2 (int P dr = N_e)."""
    w = p_density * r * h  # P dr on the log grid
    q_inner = np.cumsum(w) - 0.5 * w  # charge inside r (midpoint-corrected)
    outer = np.cumsum((w / r)[::-1])[::-1] - 0.5 * w / r
    return q_inner / r + outer


def solve_atom(
    z,
    occs,
    ecp_params=None,
    rmin=5e-4,
    rmax=60.0,
    n_grid=1600,
    mix=0.35,
    tol=1e-9,
    max_iter=300,
    p_init=None,
):
    """Spherically averaged exchange-only LDA atom, AE or with a Gaussian ECP.

    ``occs``: {l: [f_0, f_1, ...]} occupations of successive states per
    angular-momentum channel (e.g. AE carbon {0: [2, 2], 1: [2]}).
    ``ecp_params``: registry tuple (n_core, local, nonlocal) for an ECP run;
    channels beyond the projector list feel only the local part, matching the
    semi-local form sum_l [V_loc + U_l] |l><l| of GaussianTypeECP.
    """
    h, r = _log_grid(rmin, rmax, n_grid)
    if ecp_params is None:
        v_ext_by_l = {l: -z / r for l in occs}
        z_val = float(z)
    else:
        v_loc, u_l, z_val = ecp_channel_potentials(r, z, ecp_params)
        v_ext_by_l = {
            l: v_loc + (u_l[l] if l < len(u_l) else 0.0) for l in occs
        }
    n_elec = sum(f for fs in occs.values() for f in fs)
    if n_elec == 0:  # fully ionized valence (e.g. Li+ under a He-core ECP)
        return AtomSolution(
            e_total=0.0,
            eigenvalues={},
            orbitals={},
            r=r,
            occs=occs,
            iterations=0,
            converged=True,
        )

    eigenvalues, orbitals = {}, {}
    if p_init is not None:  # warm start (e.g. across fitting iterations)
        p_density = np.asarray(p_init)
    else:
        # initial guess: hydrogenic density via one noninteracting solve
        p_density = np.zeros_like(r)
        for l, fs in occs.items():
            eps, u = _solve_channel(h, r, l, v_ext_by_l[l], len(fs))
            for n, f in enumerate(fs):
                p_density += f * u[:, n] ** 2

    e_prev, converged, it = np.inf, False, 0
    for it in range(1, max_iter + 1):
        v_h = _hartree(h, r, p_density)
        rho = p_density / (4.0 * np.pi * r**2)
        v_x = (4.0 / 3.0) * _CX * rho ** (1.0 / 3.0)
        new_p = np.zeros_like(r)
        e_band = 0.0
        for l, fs in occs.items():
            eps, u = _solve_channel(h, r, l, v_ext_by_l[l] + v_h + v_x, len(fs))
            for n, f in enumerate(fs):
                eigenvalues[(l, n)] = float(eps[n])
                orbitals[(l, n)] = u[:, n]
                new_p += f * u[:, n] ** 2
                e_band += f * eps[n]
        # total energy with double-counting corrections
        dr = r * h
        e_h = 0.5 * np.sum(v_h * p_density * dr)
        e_x = _CX * np.sum(rho ** (4.0 / 3.0) * 4.0 * np.pi * r**2 * dr)
        e_vx = np.sum(v_x * p_density * dr)
        e_total = e_band - e_h - e_vx + e_x
        if abs(e_total - e_prev) < tol and it > 4:
            converged = True
            p_density = new_p
            break
        e_prev = e_total
        p_density = (1.0 - mix) * p_density + mix * new_p

    return AtomSolution(
        e_total=float(e_total),
        eigenvalues=eigenvalues,
        orbitals=orbitals,
        r=r,
        occs=occs,
        iterations=it,
        converged=converged,
        e_components={'band': float(e_band), 'hartree': float(e_h), 'x': float(e_x)},
        p_density=p_density,
    )


def solve_atom_spin(
    z,
    occs_up,
    occs_down,
    ecp_params=None,
    rmin=5e-4,
    rmax=60.0,
    n_grid=1600,
    mix=0.35,
    tol=1e-9,
    max_iter=400,
):
    """Spin-polarized (exchange-only LSDA) variant of :func:`solve_atom`.

    One level above the restricted solver on exactly the axis where it is
    least trustworthy: open shells (e.g. N 2p^3, where Hund polarization is
    maximal).  Each spin channel sees its own Dirac exchange
    ``v_x^sigma = (4/3) C_X (2 rho_sigma)^(1/3)``; the Hartree term couples
    through the total density.  Reduces exactly to :func:`solve_atom` for
    closed shells split evenly.

    ``occs_up`` / ``occs_down``: {l: [f_0, f_1, ...]} per spin.
    Returns (AtomSolution, eigenvalues_by_spin) where eigenvalues_by_spin =
    ({(l, n): eps} for up, same for down).
    """
    h, r = _log_grid(rmin, rmax, n_grid)
    all_l = sorted(set(occs_up) | set(occs_down))
    if ecp_params is None:
        v_ext_by_l = {l: -z / r for l in all_l}
    else:
        v_loc, u_l, _ = ecp_channel_potentials(r, z, ecp_params)
        v_ext_by_l = {l: v_loc + (u_l[l] if l < len(u_l) else 0.0) for l in all_l}

    spins = ({l: list(fs) for l, fs in occs.items()} for occs in (occs_up, occs_down))
    spins = tuple(spins)

    # hydrogenic initial densities
    p_spin = []
    for occs in spins:
        p = np.zeros_like(r)
        for l, fs in occs.items():
            if fs:
                _, u = _solve_channel(h, r, l, v_ext_by_l[l], len(fs))
                for n, f in enumerate(fs):
                    p += f * u[:, n] ** 2
        p_spin.append(p)

    eigenvalues = [{}, {}]
    orbitals = [{}, {}]
    e_prev, converged, it = np.inf, False, 0
    for it in range(1, max_iter + 1):
        p_total = p_spin[0] + p_spin[1]
        v_h = _hartree(h, r, p_total)
        dr = r * h
        new_p = [np.zeros_like(r), np.zeros_like(r)]
        e_band, e_vx, e_x = 0.0, 0.0, 0.0
        for s, occs in enumerate(spins):
            rho_s = p_spin[s] / (4.0 * np.pi * r**2)
            v_x = (4.0 / 3.0) * _CX * (2.0 * rho_s) ** (1.0 / 3.0)
            for l, fs in occs.items():
                if not fs:
                    continue
                eps, u = _solve_channel(h, r, l, v_ext_by_l[l] + v_h + v_x, len(fs))
                for n, f in enumerate(fs):
                    eigenvalues[s][(l, n)] = float(eps[n])
                    orbitals[s][(l, n)] = u[:, n]
                    new_p[s] += f * u[:, n] ** 2
                    e_band += f * eps[n]
            e_vx += np.sum(v_x * p_spin[s] * dr)
            e_x += 0.5 * _CX * np.sum(
                (2.0 * rho_s) ** (4.0 / 3.0) * 4.0 * np.pi * r**2 * dr
            )
        e_h = 0.5 * np.sum(v_h * p_total * dr)
        e_total = e_band - e_h - e_vx + e_x
        if abs(e_total - e_prev) < tol and it > 4:
            converged = True
            p_spin = new_p
            break
        e_prev = e_total
        p_spin = [
            (1.0 - mix) * p + mix * q for p, q in zip(p_spin, new_p)
        ]

    solution = AtomSolution(
        e_total=float(e_total),
        eigenvalues=eigenvalues[0],
        orbitals=orbitals[0],
        r=r,
        occs={'up': spins[0], 'down': spins[1]},
        iterations=it,
        converged=converged,
        e_components={'band': float(e_band), 'hartree': float(e_h), 'x': float(e_x)},
        p_density=p_spin[0] + p_spin[1],
    )
    return solution, (eigenvalues[0], eigenvalues[1])
