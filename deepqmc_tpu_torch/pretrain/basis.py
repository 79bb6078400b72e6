"""Self-contained Gaussian basis sets for the SCF pretraining baseline (a
numpy copy of ``deepqmc_tpu/pretrain/basis.py``).

The reference obtains basis sets from pyscf's library
(pretrain/pyscfext.py:95-103); pyscf is not a dependency of the TPU build, so
the default here is an *even-tempered* primitive basis generated per element:
exponents form a geometric series spanning core (~50 Z^2) to valence (~0.05)
scales for every occupied angular momentum channel.  Uncontracted
even-tempered sets of this size reproduce Hartree-Fock energies to a few mHa
— far more accurate than the reference's STO-6G default — at a cost that is
irrelevant for a one-off pretraining target.

Named Gaussian basis strings from reference configs ('sto-6g', '6-31G', ...)
are accepted and mapped onto this generator with a log notice, keeping the
config surface compatible.
"""

import logging
import math

import numpy as np

log = logging.getLogger(__name__)

__all__ = ['build_basis']

# highest occupied l per element block (H-He: s; B-Ne, Al-Ar: p; Sc-Zn: d)
def _max_l(z: int) -> int:
    if z <= 4:
        return 0
    if z <= 20:
        return 1
    return 2


def even_tempered_shells(z: int, beta: float = 2.7) -> list[tuple[int, list, list]]:
    """Shells [(l, coeffs, zetas)] of an even-tempered basis for element z."""
    shells = []
    # s channel: span valence to core scales
    alpha_min = 0.045
    alpha_max = max(45.0 * z**2, 25.0)
    n_s = max(6, math.ceil(math.log(alpha_max / alpha_min) / math.log(beta)) + 1)
    s_exps = alpha_min * beta ** np.arange(n_s)
    for a in s_exps:
        shells.append((0, [1.0], [float(a)]))
    if _max_l(z) >= 1:
        alpha_min_p = 0.05
        alpha_max_p = max(8.0 * (z / 2.0) ** 2, 10.0)
        n_p = max(
            4, math.ceil(math.log(alpha_max_p / alpha_min_p) / math.log(beta)) + 1
        )
        for a in alpha_min_p * beta ** np.arange(n_p):
            shells.append((1, [1.0], [float(a)]))
    if _max_l(z) >= 2:
        alpha_min_d = 0.08
        alpha_max_d = max(12.0 * (z / 4.0) ** 2, 10.0)
        n_d = max(
            4, math.ceil(math.log(alpha_max_d / alpha_min_d) / math.log(beta)) + 1
        )
        for a in alpha_min_d * beta ** np.arange(n_d):
            shells.append((2, [1.0], [float(a)]))
    return shells


# aufbau shell-filling order and per-shell electron capacities
_AUFBAU = [(1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (4, 0), (3, 2), (4, 1)]
_L_CAP = {0: 2, 1: 6, 2: 10}


def occupied_shells_per_l(z: int) -> dict[int, int]:
    """Number of (at least partially) occupied shells per l channel."""
    counts = {0: 0, 1: 0, 2: 0}
    remaining = int(z)
    for _n, l in _AUFBAU:
        if remaining <= 0:
            break
        counts[l] += 1
        remaining -= _L_CAP[l]
    return counts


def _cached_minimal(fn):
    cache: dict[int, list] = {}

    def wrapper(z: int):
        if z not in cache:
            cache[z] = fn(z)
        return cache[z]

    return wrapper


@_cached_minimal
def minimal_contracted_shells(z: int) -> list[tuple[int, list, list]]:
    """Minimal basis for element ``z``, contracted from its own atomic HF.

    The reference's default pretraining basis is the minimal STO-6G from
    pyscf's library (conf/task/train.yaml scf_kwargs.basis).  With no basis
    library in this build, the equivalent is derived from first principles:
    run atomic (U)HF in the big even-tempered primitive set, then extract
    one radial contraction per occupied shell of each l channel (SVD of the
    occupied-orbital coefficient block).  By construction these span the
    atomic occupied space near-exactly — at worst STO-6G quality, at a tiny
    AO count (H: 1, C: 5, Sc: 21 cartesian AOs), which keeps molecular SCF
    integrals small for large molecules (benzene: 36 AOs vs 282 primitives).
    """
    from .scf import run_hf

    shells_big = even_tempered_shells(z)
    shell_list = [(0, s) for s in shells_big]
    n_up, n_down = (z + 1) // 2, z // 2
    result = run_hf(
        np.zeros((1, 3)), np.array([float(z)]), shell_list, n_up, n_down
    )
    n_occ = n_up
    # AO rows of the engine's flat cartesian order, per (l, shell-within-l)
    n_comp = {0: 1, 1: 3, 2: 6}
    rows: dict[int, list[list[int]]] = {0: [], 1: [], 2: []}
    ao = 0
    for l, _coeffs, _zetas in shells_big:
        rows[l].append(list(range(ao, ao + n_comp[l])))
        ao += n_comp[l]
    contracted = []
    counts = occupied_shells_per_l(z)
    for l in (0, 1, 2):
        if not rows[l] or not counts[l]:
            continue
        zetas = [s[2][0] for s in shells_big if s[0] == l]
        # radial profiles: [n_shells_l, n_components * n_occ] coefficient
        # block of the occupied orbitals, leading SVD vectors = contractions
        block = np.stack(
            [result.mo_coeff[r, :n_occ].reshape(-1) for r in rows[l]]
        )
        u, s, _ = np.linalg.svd(block, full_matrices=False)
        for k in range(min(counts[l], u.shape[1])):
            contracted.append((l, [float(c) for c in u[:, k]], zetas))
    return contracted


def build_basis(charges, basis: str = 'even-tempered'):
    """Return the shell list [(atom_idx, (l, coeffs, zetas)), ...].

    Minimal-basis names ('sto-6g', 'sto-3g', 'minao', 'minimal') map onto
    the atomic-HF-contracted minimal set (matching the reference's minimal
    STO-6G default in role and size); any other name maps onto the big
    uncontracted even-tempered generator with a notice.
    """
    name = basis.replace('_', '-').lower()
    minimal = name.startswith('sto') or name in ('minimal', 'minao')
    if minimal:
        log.info(
            f'Using the built-in atomic-HF-contracted minimal basis in place'
            f' of {basis!r} (external basis-set libraries are not a'
            ' dependency of this build).'
        )
    elif name not in ('even-tempered', 'eventempered'):
        log.info(
            f'Using the built-in even-tempered basis in place of {basis!r}'
            ' (external basis-set libraries are not a dependency of this build).'
        )
    zs = np.asarray(charges).astype(int)
    if not minimal and name not in ('even-tempered', 'eventempered'):
        # a foreign basis name mapped onto the big generator: guard against
        # pathological AO counts (the in-house ERI assembly is O(nao^4))
        n_comp = {0: 1, 1: 3, 2: 6}
        n_ao = sum(
            n_comp[l] for z in zs for l, _c, _z in even_tempered_shells(int(z))
        )
        if n_ao > 128:
            log.warning(
                f'The uncontracted even-tempered stand-in for {basis!r} has'
                f' {n_ao} cartesian AOs for this system; falling back to the'
                ' atomic-HF-contracted minimal basis to keep the in-house SCF'
                " tractable (pass basis='even-tempered' explicitly to force"
                ' the big basis).'
            )
            minimal = True
    shells = []
    for atom_idx, z in enumerate(zs):
        element_shells = (
            minimal_contracted_shells(int(z))
            if minimal
            else even_tempered_shells(int(z))
        )
        for l, coeffs, zetas in element_shells:
            shells.append((atom_idx, (l, coeffs, zetas)))
    return shells
