"""(MC-)SCF target orbitals for pretraining (counterpart of
``deepqmc_tpu/pretrain/pretraining_target.py``), over a batch of walkers."""

import torch

from ..physics import pairwise_diffs
from .gto import GTOBasis

__all__ = ['PretrainTarget']


class PretrainTarget:
    """Baseline determinant orbitals at sampled configurations.

    ``mo_coeffs`` ``[n_mols, n_ao, n_mo]``; the basis and coefficients are
    moved to ``dtype`` and ``device`` once, here.
    """

    def __init__(self, hamil, n_determinants, centers, shells, mo_coeffs, *,
                 dtype=torch.float64, device=None):
        self.n_determinants = n_determinants
        self.basis = GTOBasis(centers, shells).to(device=device, dtype=dtype)
        self.mo_coeffs = torch.as_tensor(mo_coeffs).to(device=device, dtype=dtype)

    def __call__(self, confs, conf_coeffs, phys_conf):
        """``confs`` ``[n_mols, n_det, n_el]`` and ``conf_coeffs`` ``[n_mols,
        n_det]`` are selected per walker by ``phys_conf.mol_idx`` ``[B]``;
        ``phys_conf.r`` ``[B, n_el, 3]``, ``phys_conf.R`` ``[n_nuc, 3]`` (or
        per walker, ``[B, n_nuc, 3]``).
        Returns ``[B, n_det, n_el, n_orb]``."""
        i = phys_conf.mol_idx
        aos = self.basis(pairwise_diffs(phys_conf.r, phys_conf.R))  # [B, n_el, n_ao]
        mos = aos @ self.mo_coeffs[i]  # [B, n_el, n_mo]
        confs_i = confs.to(mos.device)[i]  # [B, n_det, n_slot]
        B, n_det, n_slot = confs_i.shape
        dets = mos[:, None].expand(B, n_det, *mos.shape[1:]).gather(
            -1, confs_i[:, :, None, :].expand(B, n_det, mos.shape[1], n_slot))
        factors = _fold_ci_coefficients(conf_coeffs.to(mos)[i], dets.shape[-2])
        if self.n_determinants:
            dets = dets[:, :self.n_determinants]
            factors = factors[:, :self.n_determinants]
        return dets * factors[..., None, :]


def _fold_ci_coefficients(cc, n_el):
    """Spread each determinant's CI magnitude evenly over its orbitals and
    put the CI sign on the first orbital, so det(c^(1/n) * orbitals) = c * det."""
    on_first = torch.zeros(n_el, dtype=cc.dtype, device=cc.device)
    on_first[0] = 1
    signed_first = on_first * torch.sign(cc)[..., None] + (1 - on_first)
    return (torch.abs(cc) ** (1 / n_el))[..., None] * signed_first
