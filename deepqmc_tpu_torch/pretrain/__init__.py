"""SCF pretraining baseline (counterpart of ``deepqmc_tpu/pretrain``):
in-house Hartree-Fock in numpy, GTO evaluation and the orbital-MSE loop.

The dataset has the JAX package's layout (``centers``, ``shells``,
``mo_coeffs``, ``confs`` ``[n_mols, n_states, n_det, n_el]``,
``conf_coeffs``) as CPU tensors in float64 (the orbital indices as long).
CASCI targets (``cas``) are not ported yet: they come with excited states.
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
from .pretraining import pretrain
from .pretraining_target import PretrainTarget
from .scf import compute_integrals, run_hf

log = logging.getLogger(__name__)

__all__ = ['compute_scf_solution', 'pretrain', 'PretrainTarget']


def compute_scf_solution(
    mols: Union[Molecule, list[Molecule]],
    hamil,
    n_states: int,
    *,
    basis: str = 'even-tempered',
    cas: Optional[tuple[int, int]] = None,
    workdir: Optional[str] = None,
    **kwargs,
) -> dict:
    """SCF solutions for ``mols`` as a pretraining dataset: every state's
    target is the HF ground-state determinant.  With ``workdir`` each
    molecule's solution is kept in ``workdir/scf_chkpts/mol_{i}.npz`` (a
    pickle) and restored from there.  The JAX package's other keywords
    (``fix_spin``, ``state_avg``) act only with ``cas`` and are ignored, as
    there."""
    if cas is not None:
        raise NotImplementedError(
            f'cas={cas}: CASCI pretraining targets are not ported yet; they come with '
            'excited states (ROADMAP.md, queue 1 item 7)'
        )
    mols = mols if isinstance(mols, Sequence) else [mols]
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
            if saved.get('cas') is not None or saved.get('n_states', 1) < n_states:
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
            ground = list(range(hamil.n_up)) + list(range(hamil.n_down))
            confs_i = np.asarray([[ground]] * n_states)
            conf_coeffs_i = np.ones((n_states, 1))
            if chkfile:
                with open(chkfile, 'wb') as f:
                    pickle.dump({'mo_coeff': mo, 'e_tot': result.e_tot, 'cas': None,
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
