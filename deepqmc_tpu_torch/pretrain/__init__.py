"""SCF pretraining baseline (counterpart of ``deepqmc_tpu/pretrain``):
in-house Hartree-Fock in numpy, GTO evaluation and the orbital-MSE loop.

The dataset has the JAX package's layout (``centers``, ``shells``,
``mo_coeffs``, ``confs`` ``[n_mols, n_states, n_det, n_el]``,
``conf_coeffs``) as CPU tensors in float64 (the orbital indices as long).
With ``cas`` each state's target is a CASCI root over the HF orbitals
(:mod:`.casci`), all its determinants sorted by falling CI weight.
The molecular SCF returns the orbitals of its converged Fock matrix
(``run_hf(converged_fock=True)``), not those of the JAX package's last DIIS
extrapolation, which a rounding-level change of the integrals can move.
"""

import logging
import os
import pickle
from collections.abc import Sequence
from typing import Optional, Union

import numpy as np
import torch

from ..molecule import Molecule
from .basis import build_basis
from .casci import _mo_eri, run_casci
from .pretraining import pretrain
from .pretraining_target import PretrainTarget
from .scf import compute_integrals, run_hf

log = logging.getLogger(__name__)

__all__ = ['compute_scf_solution', 'pretrain', 'PretrainTarget']


def _casci_confs(hamil, integrals, mo_coeff, cas, n_states, fix_spin):
    """Per-state (confs ``[n_states, n_det, n_el]``, conf_coeffs ``[n_states,
    n_det]``): every determinant of the active space, up (core, then active)
    then down orbital indices, sorted per state by falling CI weight."""
    h_mo = mo_coeff.T @ integrals.Hcore @ mo_coeff
    result = run_casci(h_mo, _mo_eri(integrals.eri, mo_coeff), integrals.e_nuc, hamil.n_up,
                       hamil.n_down, tuple(cas), n_states=n_states, fix_spin=fix_spin)
    log.info('CASCI state energies: ' + ', '.join(f'{e:.6f}' for e in result.energies)
             + ' Ha (S^2: ' + ', '.join(f'{s:.2f}' for s in result.s2) + ')')
    core = np.arange(result.n_core)
    dets = np.concatenate([
        np.tile(core, (len(result.up_occs), 1)), result.up_occs + result.n_core,
        np.tile(core, (len(result.down_occs), 1)), result.down_occs + result.n_core,
    ], axis=-1)
    confs, conf_coeffs = [], []
    for coeffs in result.ci_coeffs:
        order = np.argsort(-(coeffs**2))
        confs.append(dets[order])
        conf_coeffs.append(coeffs[order])
    return np.stack(confs), np.stack(conf_coeffs)


def compute_scf_solution(
    mols: Union[Molecule, list[Molecule]],
    hamil,
    n_states: int,
    *,
    basis: str = 'even-tempered',
    cas: Optional[tuple[int, int]] = None,
    workdir: Optional[str] = None,
    fix_spin: Optional[float] = None,
    state_avg: bool = True,
    **kwargs,
) -> dict:
    """(CAS)SCF solutions for ``mols`` as a pretraining dataset.  Without
    ``cas`` every state's target is the HF ground-state determinant; with
    ``cas = (ncas, nelecas)`` state s's target is root s of the CASCI over the
    HF orbitals, the roots of several states taken in the Hamiltonian's spin
    sector unless ``fix_spin`` (an S^2 value) names another.  ``state_avg``
    is taken and unused, as in the JAX package (CASCI has no orbital
    optimization to average).  With ``workdir`` each molecule's solution is
    kept in ``workdir/scf_chkpts/mol_{i}.npz`` (a pickle) and restored from
    there."""
    mols = mols if isinstance(mols, Sequence) else [mols]
    if fix_spin is None and cas is not None and n_states > 1:
        s = (hamil.n_up - hamil.n_down) / 2
        fix_spin = s * (s + 1)
    chkpt_dir = f'{workdir}/scf_chkpts' if workdir else None
    if chkpt_dir:
        os.makedirs(chkpt_dir, exist_ok=True)

    shells = build_basis(hamil.mol.charges, basis)
    mo_coeffs, confs, conf_coeffs = [], [], []
    centers = None
    for i, mol in enumerate(mols):
        chkfile = chkpt_dir and f'{chkpt_dir}/mol_{i}.npz'
        centers = np.asarray(mol.coords)
        if chkfile and os.path.exists(chkfile):
            log.info(f'Restoring SCF solution from {chkfile}')
            with open(chkfile, 'rb') as f:
                saved = pickle.load(f)
            if (saved.get('cas') != (tuple(cas) if cas else None)
                    or saved.get('n_states', 1) < n_states):
                raise ValueError(
                    f'SCF checkpoint {chkfile} was computed with different'
                    ' cas/n_states settings; remove it to recompute.'
                )
            mo = saved['mo_coeff']
            confs_i = saved['confs'][:n_states]
            conf_coeffs_i = saved['conf_coeffs'][:n_states]
        else:
            integrals = compute_integrals(centers, np.asarray(hamil.ns_valence), shells)
            result = run_hf(centers, np.asarray(hamil.ns_valence), shells, hamil.n_up,
                            hamil.n_down, integrals=integrals, converged_fock=True)
            mo = result.mo_coeff
            if cas is not None:
                confs_i, conf_coeffs_i = _casci_confs(hamil, integrals, mo, cas, n_states,
                                                      fix_spin)
            else:
                ground = list(range(hamil.n_up)) + list(range(hamil.n_down))
                confs_i = np.asarray([[ground]] * n_states)
                conf_coeffs_i = np.ones((n_states, 1))
            if chkfile:
                with open(chkfile, 'wb') as f:
                    pickle.dump({'mo_coeff': mo, 'e_tot': result.e_tot,
                                 'cas': tuple(cas) if cas else None,
                                 'n_states': n_states, 'confs': confs_i,
                                 'conf_coeffs': conf_coeffs_i}, f)
        mo_coeffs.append(torch.as_tensor(mo, dtype=torch.float64))
        confs.append(torch.as_tensor(confs_i, dtype=torch.long))  # [n_states, n_det, n_el]
        conf_coeffs.append(torch.as_tensor(conf_coeffs_i, dtype=torch.float64))

    return {
        'centers': torch.as_tensor(centers, dtype=torch.float64),
        'shells': shells,
        'mo_coeffs': torch.stack(mo_coeffs),
        'confs': torch.stack(confs),  # [n_mols, n_states, n_det, n_el]
        'conf_coeffs': torch.stack(conf_coeffs),
    }
