"""In-house Hartree-Fock solver for pretraining baselines (a numpy copy of
``deepqmc_tpu/pretrain/scf.py``).

Replaces the reference's pyscf RHF dependency (pretrain/pyscfext.py:104-107).
Restricted (closed-shell) and unrestricted (open-shell) HF with DIIS
acceleration over the integrals from :mod:`.integrals`.  MO coefficients are
expressed directly in the normalization convention of
:class:`.gto.GTOBasis`, so they can be contracted with
its AO values without any overlap rescaling.

One departure from the JAX package, asked for with ``converged_fock=True``
(the molecular SCF of the pretraining target): a converged run returns the
orbitals of the Fock matrix of the density that passed the convergence test,
where the JAX package returns those of one more DIIS-extrapolated Fock matrix.
"""

import logging
from typing import NamedTuple, Optional

import numpy as np

from .integrals import IntegralEngine

log = logging.getLogger(__name__)

__all__ = ['run_hf', 'HFResult', 'Integrals', 'compute_integrals']


class HFResult(NamedTuple):
    mo_coeff: np.ndarray  # [n_ao, n_mo] (alpha set for open shells)
    mo_energy: np.ndarray
    e_tot: float
    converged: bool


class Integrals(NamedTuple):
    """AO-basis integrals shared between HF and post-HF (CASCI) steps."""

    S: np.ndarray
    Hcore: np.ndarray
    eri: np.ndarray  # chemist notation (pq|rs)
    e_nuc: float


def compute_integrals(centers, charges_for_potential, shells) -> Integrals:
    engine = IntegralEngine(centers, shells)
    return Integrals(
        engine.overlap(),
        engine.kinetic() + engine.nuclear(centers, charges_for_potential),
        engine.eri(),
        _nuclear_repulsion(centers, charges_for_potential),
    )


def _nuclear_repulsion(centers, charges) -> float:
    centers = np.asarray(centers, float)
    charges = np.asarray(charges, float)
    e = 0.0
    for i in range(len(charges)):
        for j in range(i):
            e += charges[i] * charges[j] / np.linalg.norm(centers[i] - centers[j])
    return e


def _orthogonalizer(S: np.ndarray, lin_dep_tol: float = 1e-8) -> np.ndarray:
    """Canonical orthogonalization, dropping linearly dependent combinations."""
    w, v = np.linalg.eigh(S)
    keep = w > lin_dep_tol * w.max()
    if not keep.all():
        log.debug(f'Dropping {np.sum(~keep)} linearly dependent AO combinations')
    return v[:, keep] / np.sqrt(w[keep])


class _DIIS:
    def __init__(self, max_vecs: int = 8):
        self.errors: list[np.ndarray] = []
        self.focks: list[np.ndarray] = []
        self.max_vecs = max_vecs

    def update(self, fock, error):
        self.focks.append(fock)
        self.errors.append(error.reshape(-1))
        if len(self.focks) > self.max_vecs:
            self.focks.pop(0)
            self.errors.pop(0)
        m = len(self.focks)
        if m < 2:
            return fock
        B = -np.ones((m + 1, m + 1))
        B[-1, -1] = 0.0
        for i in range(m):
            for j in range(m):
                B[i, j] = self.errors[i] @ self.errors[j]
        rhs = np.zeros(m + 1)
        rhs[-1] = -1.0
        try:
            coeffs = np.linalg.solve(B, rhs)[:m]
        except np.linalg.LinAlgError:
            return fock
        return sum(c * f for c, f in zip(coeffs, self.focks))


def run_hf(
    centers,
    charges_for_potential,
    shells,
    n_up: int,
    n_down: int,
    *,
    max_iter: int = 200,
    tol: float = 1e-9,
    integrals: Optional[Integrals] = None,
    converged_fock: bool = False,
) -> HFResult:
    """Run (U)HF; ``charges_for_potential`` may be valence charges under ECPs.

    Near convergence the DIIS system is so ill-conditioned that a
    rounding-level change of the integrals moves the extrapolated orbitals by
    up to 1e-3 (LiH, 'sto-6g').  With ``converged_fock`` a converged run
    returns the orbitals of the Fock matrix whose density passed the test
    instead; without it, the JAX package's orbitals (the atomic runs that
    contract the minimal basis keep those, equal to the JAX package's bit for
    bit)."""
    if integrals is None:
        integrals = compute_integrals(centers, charges_for_potential, shells)
    S, Hcore, eri, e_nuc = integrals
    log.info(f'HF: {S.shape[0]} cartesian AOs, {n_up}+{n_down} electrons')
    X = _orthogonalizer(S)

    def solve_fock(F):
        Fp = X.T @ F @ X
        eps, Cp = np.linalg.eigh(Fp)
        return eps, X @ Cp

    def density(C, n_occ):
        Cocc = C[:, :n_occ]
        return Cocc @ Cocc.T

    eps, C = solve_fock(Hcore)
    Ca = Cb = C
    diis_a, diis_b = _DIIS(), _DIIS()
    e_old = None
    converged = False
    restricted = n_up == n_down
    for it in range(max_iter):
        Da = density(Ca, n_up)
        Db = Da if restricted else density(Cb, n_down)
        D = Da + Db
        J = np.einsum('pqrs,rs->pq', eri, D, optimize=True)
        Ka = np.einsum('prqs,rs->pq', eri, Da, optimize=True)
        Fa = Hcore + J - Ka
        if restricted:
            Fb = Fa
        else:
            Kb = np.einsum('prqs,rs->pq', eri, Db, optimize=True)
            Fb = Hcore + J - Kb
        e_elec = 0.5 * (np.sum(Da * (Hcore + Fa)) + np.sum(Db * (Hcore + Fb)))
        e_tot = e_elec + e_nuc
        err_a = Fa @ Da @ S - S @ Da @ Fa
        if e_old is not None and abs(e_tot - e_old) < tol and np.abs(
            err_a
        ).max() < 1e-6:
            converged = True
            if converged_fock:
                eps_a, Ca = solve_fock(Fa)
                break
        Fa_diis = diis_a.update(Fa, err_a)
        eps_a, Ca = solve_fock(Fa_diis)
        if not restricted:
            err_b = Fb @ Db @ S - S @ Db @ Fb
            Fb_diis = diis_b.update(Fb, err_b)
            _, Cb = solve_fock(Fb_diis)
        if converged:
            break
        e_old = e_tot
    if not converged:
        log.warning(f'HF did not fully converge in {max_iter} iterations')
    log.info(f'HF energy: {e_tot:.6f} Ha')
    if not restricted:
        log.info('Open shell: using the alpha orbital set as pretraining target')
    return HFResult(Ca, eps_a, float(e_tot), converged)
