"""CASCI: full CI in an active space of HF orbitals, for pretraining targets
(the port's own copy of ``deepqmc_tpu/pretrain/casci.py``, numpy only).

Multi-determinant, per-state pretraining targets come from complete CI in an
``(ncas, nelecas)`` active space built on the HF orbitals (CASCI — no
orbital reoptimization, which pretraining targets do not need), with exact
S^2 filtering of the computed roots.

The determinant basis is represented by per-spin orbital-occupation
bitmasks, with the fermionic ordering "all alpha spin-orbitals (ascending),
then all beta" — the same string convention as pyscf's FCI, so the extracted
CI coefficients carry directly over to DeepQMC's determinant format.
The Hamiltonian is assembled operator-wise — h_ij a+_i a_j plus
(ij|kl)/2 a+_i a+_k a_l a_j — with every elementary fermionic step
vectorized over the whole determinant array via bit arithmetic, instead of
pairwise Slater-Condon case analysis.
"""

import logging
from itertools import combinations
from typing import NamedTuple, Optional

import numpy as np

log = logging.getLogger(__name__)

__all__ = ['run_casci', 'CASCIResult']


class CASCIResult(NamedTuple):
    energies: np.ndarray  # [n_states] total energies (incl. core + nuclear)
    ci_coeffs: np.ndarray  # [n_states, n_det]
    up_occs: np.ndarray  # [n_det, n_active_up] active orbital indices
    down_occs: np.ndarray  # [n_det, n_active_down]
    s2: np.ndarray  # [n_states] <S^2> of each root
    n_core: int


def _mo_eri(eri_ao: np.ndarray, C: np.ndarray) -> np.ndarray:
    """Staged 4-index transform of chemist-notation (pq|rs) integrals."""
    x = np.einsum('pqrs,pi->iqrs', eri_ao, C, optimize=True)
    x = np.einsum('iqrs,qj->ijrs', x, C, optimize=True)
    x = np.einsum('ijrs,rk->ijks', x, C, optimize=True)
    return np.einsum('ijks,sl->ijkl', x, C, optimize=True)


def active_space_integrals(h_mo, eri_mo, n_core, ncas):
    """Fold the doubly-occupied core into (h_eff, eri_active, e_core)."""
    core = slice(0, n_core)
    act = slice(n_core, n_core + ncas)
    e_core = 2 * np.trace(h_mo[core, core])
    e_core += 2 * np.einsum('iijj->', eri_mo[core, core, core, core])
    e_core -= np.einsum('ijji->', eri_mo[core, core, core, core])
    h_eff = (
        h_mo[act, act]
        + 2 * np.einsum('ijcc->ij', eri_mo[act, act, core, core])
        - np.einsum('iccj->ij', eri_mo[act, core, core, act])
    )
    return h_eff, np.ascontiguousarray(eri_mo[act, act, act, act]), float(e_core)


class _DetBasis:
    """All (n_up, n_down)-electron determinants over ``ncas`` orbitals."""

    def __init__(self, ncas: int, n_up: int, n_down: int):
        assert ncas <= 30, 'active spaces beyond 30 orbitals are not supported'
        self.ncas = ncas
        up_list = [
            sum(1 << p for p in occ) for occ in combinations(range(ncas), n_up)
        ]
        down_list = [
            sum(1 << p for p in occ) for occ in combinations(range(ncas), n_down)
        ]
        up, down = np.meshgrid(
            np.asarray(up_list, np.int64), np.asarray(down_list, np.int64),
            indexing='ij',
        )
        self.up = up.reshape(-1)
        self.down = down.reshape(-1)
        self.keys = self.up << ncas | self.down
        order = np.argsort(self.keys)
        self.up, self.down, self.keys = (
            self.up[order], self.down[order], self.keys[order],
        )
        self.n = len(self.keys)

    def index_of(self, up, down):
        keys = up << self.ncas | down
        idx = np.searchsorted(self.keys, keys)
        idx = np.clip(idx, 0, self.n - 1)
        ok = self.keys[idx] == keys
        return idx, ok

    def occ_lists(self):
        """Ascending active-orbital indices per determinant and spin."""
        bits = (self.up[:, None] >> np.arange(self.ncas)[None, :]) & 1
        n_up = int(bits[0].sum())
        up_occ = np.nonzero(bits)[1].reshape(self.n, n_up)
        bits = (self.down[:, None] >> np.arange(self.ncas)[None, :]) & 1
        n_down = int(bits[0].sum())
        down_occ = np.nonzero(bits)[1].reshape(self.n, n_down)
        return up_occ, down_occ


def _popcount(x) -> np.ndarray:
    """The number of set bits of each entry of the non-negative int64 array ``x``."""
    x = np.asarray(x, np.int64)
    if hasattr(np, 'bitwise_count'):  # numpy >= 2.0
        return np.bitwise_count(x.astype(np.uint64)).astype(np.int64)
    count = np.zeros(x.shape, np.int64)
    while np.any(x):
        count += x & 1
        x = x >> 1
    return count


def _parity_below(mask, p):
    """(-1)^(number of set bits below position p)."""
    below = _popcount(mask & ((1 << p) - 1))
    return 1 - 2 * (below & 1)


class _Dets:
    """A batch of kets under elementary fermionic operators (vectorized).

    Spin-orbital ordering for signs: all up orbitals (ascending), then all
    down — pyscf's alpha-string-first convention.
    """

    def __init__(self, up, down, sign=None, alive=None):
        self.up = up.copy()
        self.down = down.copy()
        self.sign = np.ones(len(up), np.int64) if sign is None else sign.copy()
        self.alive = (
            np.ones(len(up), bool) if alive is None else alive.copy()
        )

    def _mask_and_parity(self, p, spin):
        if spin == 0:
            return self.up, _parity_below(self.up, p)
        n_up_parity = 1 - 2 * (_popcount(self.up) & 1)
        return self.down, n_up_parity * _parity_below(self.down, p)

    def annihilate(self, p, spin):
        mask, parity = self._mask_and_parity(p, spin)
        bit = np.int64(1) << p
        self.alive &= (mask & bit) != 0
        self.sign *= parity
        if spin == 0:
            self.up = self.up & ~bit
        else:
            self.down = self.down & ~bit
        return self

    def create(self, p, spin):
        mask, parity = self._mask_and_parity(p, spin)
        bit = np.int64(1) << p
        empty = (mask & bit) == 0
        self.alive &= empty
        self.sign *= parity
        if spin == 0:
            self.up = self.up | bit
        else:
            self.down = self.down | bit
        return self


def _accumulate(H, basis, dets, col_weight):
    """H[row(dets), col] += sign * col_weight for surviving dets."""
    idx, ok = basis.index_of(dets.up, dets.down)
    ok &= dets.alive
    if not ok.any():
        return
    np.add.at(
        H,
        (idx[ok], np.nonzero(ok)[0]),
        dets.sign[ok] * col_weight,
    )


def build_hamiltonian(h_eff, eri_act, basis: _DetBasis) -> np.ndarray:
    """Dense active-space Hamiltonian in the determinant basis."""
    ncas = h_eff.shape[0]
    H = np.zeros((basis.n, basis.n))
    kets = _Dets(basis.up, basis.down)
    for i in range(ncas):
        for j in range(ncas):
            for spin in (0, 1):
                if abs(h_eff[i, j]) < 1e-14:
                    continue
                d = _Dets(kets.up, kets.down)
                d.annihilate(j, spin).create(i, spin)
                _accumulate(H, basis, d, h_eff[i, j])
    for i in range(ncas):
        for j in range(ncas):
            for k in range(ncas):
                for l in range(ncas):  # noqa: E741
                    v = eri_act[i, j, k, l]
                    if abs(v) < 1e-14:
                        continue
                    for s1 in (0, 1):
                        for s2 in (0, 1):
                            # a+_{i s1} a+_{k s2} a_{l s2} a_{j s1}
                            d = _Dets(kets.up, kets.down)
                            d.annihilate(j, s1).annihilate(l, s2)
                            d.create(k, s2).create(i, s1)
                            _accumulate(H, basis, d, 0.5 * v)
    return H


def build_s2(basis: _DetBasis) -> np.ndarray:
    """Exact S^2 matrix: S_z(S_z+1) + S_- S_+ in the determinant basis."""
    ncas = basis.ncas
    n_up = _popcount(basis.up)
    n_down = _popcount(basis.down)
    sz = 0.5 * (n_up - n_down)
    S2 = np.diag(sz * (sz + 1))
    # S_+ = sum_p a+_{p up} a_{p down}; S_- S_+ = sum_{pq} a+_{q dn} a_{q up}
    # a+_{p up} a_{p dn}; go through the (n_up+1, n_down-1) sector explicitly
    for p in range(ncas):
        for q in range(ncas):
            d = _Dets(basis.up, basis.down)
            d.annihilate(p, 1).create(p, 0)  # S_+ component p
            d.annihilate(q, 0).create(q, 1)  # S_- component q
            _accumulate(S2, basis, d, 1.0)
    return S2


def run_casci(
    h_mo: np.ndarray,
    eri_mo: np.ndarray,
    e_nuc: float,
    n_up: int,
    n_down: int,
    cas: tuple[int, int],
    n_states: int = 1,
    fix_spin: Optional[float] = None,
    spin_tol: float = 1e-4,
) -> CASCIResult:
    """Diagonalize the (ncas, nelecas) active space over HF orbitals.

    ``h_mo``/``eri_mo`` are the one/two-electron integrals in the MO basis
    (chemist notation); ``cas = (ncas, nelecas)`` follows DeepQMC's
    CASSCF(ncas, nelecas) convention, with the open-shell split
    ``nelecas_up - nelecas_down = n_up - n_down``.
    """
    ncas, nelecas = cas
    spin = n_up - n_down
    cas_up = (nelecas + spin) // 2
    cas_down = (nelecas - spin) // 2
    n_core = n_up - cas_up
    assert n_core == n_down - cas_down and n_core >= 0, (
        f'inconsistent active space {cas} for {n_up}+{n_down} electrons'
    )
    assert n_core + ncas <= h_mo.shape[0], 'not enough orbitals for CAS'

    h_eff, eri_act, e_core = active_space_integrals(h_mo, eri_mo, n_core, ncas)
    basis = _DetBasis(ncas, cas_up, cas_down)
    log.info(
        f'CASCI({ncas}, {nelecas}): {basis.n} determinants,'
        f' {n_core} core orbitals'
    )
    H = build_hamiltonian(h_eff, eri_act, basis)
    S2 = build_s2(basis)
    # H and S^2 commute; a small S^2 shift splits accidental degeneracies
    # between spin sectors so eigenvectors are S^2 eigenstates
    w, v = np.linalg.eigh(H + 1e-7 * S2)
    s2_of = np.einsum('in,ij,jn->n', v, S2, v)
    w = w - 1e-7 * s2_of
    if fix_spin is not None:
        keep = np.abs(s2_of - fix_spin) < spin_tol
        if keep.sum() < n_states:
            raise ValueError(
                f'only {int(keep.sum())} roots with S^2 = {fix_spin} in the'
                f' {cas} active space, {n_states} states requested'
            )
        w, v, s2_of = w[keep], v[:, keep], s2_of[keep]
    if len(w) < n_states:
        raise ValueError(
            f'active space {cas} has only {len(w)} roots,'
            f' {n_states} states requested'
        )
    up_occ, down_occ = basis.occ_lists()
    return CASCIResult(
        energies=w[:n_states] + e_core + e_nuc,
        ci_coeffs=v[:, :n_states].T,
        up_occs=up_occ,
        down_occs=down_occ,
        s2=s2_of[:n_states],
        n_core=n_core,
    )
