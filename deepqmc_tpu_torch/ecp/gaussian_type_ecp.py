"""Gaussian-type semi-local effective core potentials (counterpart of
``deepqmc_tpu/ecp/gaussian_type_ecp.py``), batched over walkers.

The local part is the effective Coulomb term of the valence charges plus
Gaussian-damped r^-1, r^0 and r^1 classes; the nonlocal part projects onto
angular-momentum channels with the 12-point icosahedral quadrature, 12
plain forwards of the wave function per (electron, ECP nucleus) pair per
walker.  Those forwards run without autograd, in chunks of at most
``chunk`` configurations (whole walkers), so memory stays bounded whatever
the batch.
"""

from typing import Optional

import numpy as np
import torch
from numpy.polynomial import legendre

from ..physics import pairwise_distance
from .data import get_ecp_params
from .ecp_utils import get_quadrature_points, get_unit_icosahedron_sph

__all__ = ['GaussianTypeECP', 'NL_CHUNK', 'parse_gaussian_type_ecp_params']

# quadrature configurations per forward of the nonlocal part: 40 walkers of
# ScO with 17 valence electrons (17 * 12 configurations each)
NL_CHUNK = 8192


def _pad_3d(arrays) -> np.ndarray:
    """Zero-pad 3D arrays to a common shape and stack them."""
    arrays = [np.asarray(a, dtype=float) for a in arrays]
    target = np.array([a.shape for a in arrays]).max(axis=0)
    return np.array([np.pad(a, [(0, int(target[i]) - a.shape[i]) for i in range(3)])
                     for a in arrays])


def parse_gaussian_type_ecp_params(charges, ecp_type, ecp_mask):
    """Dense, zero-padded parameter arrays of the nuclei: ``ns_valence``
    ``[n_nuc]``, ``loc_params`` ``[n_nuc, 3, 2, n_terms]`` and ``nl_params``
    ``[n_nuc, l_max + 1, 2, n_terms]`` (``[alpha, beta]`` on the axis of 2)."""
    ns_valence, loc_params, nl_params = [], [], []
    max_loc_terms = 0
    for i, z in enumerate(np.asarray(charges).astype(int)):
        if ecp_mask[i]:
            n_core, local, nonlocal_ = get_ecp_params(ecp_type, int(z))
            max_loc_terms = max(max_loc_terms, *(len(c) for c in local), 1)
            if nonlocal_ and any(len(c) for c in nonlocal_):
                # channels may carry different term counts: pad to [l, n_terms, 2]
                width = max(len(c) for c in nonlocal_)
                padded = [c + [[0.0, 0.0]] * (width - len(c)) for c in nonlocal_]
                nl = np.array(padded).swapaxes(-1, -2)
            else:
                nl = np.zeros((1, 2, 0))
        else:
            n_core, local, nl = 0, [[], [], []], np.zeros((1, 2, 0))
        ns_valence.append(int(z) - n_core)
        loc_params.append(local)
        nl_params.append(nl)
    padded_loc = []
    for local in loc_params:
        local = [cls + [[0.0, 0.0]] * (max_loc_terms - len(cls)) for cls in local]
        padded_loc.append(np.swapaxes(np.array(local, dtype=float), -1, -2))
    return np.asarray(ns_valence, dtype=float), np.array(padded_loc), _pad_3d(nl_params)


class GaussianTypeECP:
    """Semi-local ECP ``sum_l V_l(r) |lm><lm|`` with Gaussian radial functions."""

    def __init__(self, charges, ecp_type: Optional[str], ecp_mask):
        self.ecp_mask = np.asarray(ecp_mask, bool)
        self.ns_valence, self.loc_params, self.nl_params = parse_gaussian_type_ecp_params(
            charges, ecp_type, self.ecp_mask)
        self.nuc_with_nl_pot = np.unique(np.nonzero(self.nl_params)[0])
        cos_theta = np.cos(get_unit_icosahedron_sph()[:, 0])
        l_max_p1 = self.nl_params.shape[1]
        # Legendre polynomials at the vertices' polar angles [12, l_max + 1]
        self.legendre_values = np.stack(
            [legendre.legval(cos_theta, [0] * l + [1]) for l in range(l_max_p1)], axis=-1)

    def local_potential(self, r: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
        """The local part ``[B]`` for electrons ``r`` ``[B, n, 3]``, nuclei ``R``."""
        dists = pairwise_distance(r, R)  # [B, n, n_nuc]
        ns_valence = torch.as_tensor(self.ns_valence, dtype=r.dtype, device=r.device)
        effective_coulomb = -(ns_valence / dists).sum((-1, -2))
        r_en = dists[..., torch.as_tensor(self.ecp_mask, device=r.device)]  # [B, n, n_ecp]
        loc = torch.as_tensor(self.loc_params[self.ecp_mask], dtype=r.dtype, device=r.device)
        alpha, beta = loc[:, :, 0], loc[:, :, 1]  # [n_ecp, 3, n_terms]
        gauss = torch.exp(-alpha * (r_en**2)[..., None, None])  # [B, n, n_ecp, 3, n_terms]
        radial = torch.stack([1 / r_en, torch.ones_like(r_en), r_en], dim=-1)
        return effective_coulomb + (beta * gauss * radial[..., None]).sum((-1, -2, -3, -4))

    @property
    def has_nonlocal(self) -> bool:
        return len(self.nuc_with_nl_pot) > 0

    @torch.no_grad()
    def nonloc_potential(self, phys_conf, wf, phi: Optional[torch.Tensor],
                         chunk: int = NL_CHUNK) -> torch.Tensor:
        """The 12-point quadrature estimate ``[B]`` of the nonlocal part for the
        walkers of ``phys_conf`` under the wave function ``wf``.

        The azimuthal rotations are ``phi`` ``[n_nl_nuc, B, n]`` (one row per
        nucleus of ``nuc_with_nl_pot``; None without a nonlocal part).
        """
        r, R = phys_conf.r, phys_conf.R
        B, n, _ = r.shape
        if not self.has_nonlocal:
            return torch.zeros(B, dtype=r.dtype, device=r.device)
        psi = wf(phys_conf)
        den_sign, den_log = psi.sign, psi.log
        legendre_values = torch.as_tensor(self.legendre_values, dtype=r.dtype, device=r.device)
        l_max_p1 = legendre_values.shape[-1]
        channel_weights = (2 * torch.arange(l_max_p1, dtype=r.dtype, device=r.device) + 1) / 12
        walkers = max(1, chunk // (12 * n))
        total = torch.zeros(B, dtype=r.dtype, device=r.device)
        per_walker = R.dim() == 3  # a flat batch of several molecules
        for k, i in enumerate(self.nuc_with_nl_pot):
            nl = torch.as_tensor(self.nl_params[i], dtype=r.dtype, device=r.device)
            R_i = R[..., i, :]  # [3], or [B, 3] per walker
            d2 = ((r - (R_i[:, None] if per_walker else R_i)) ** 2).sum(-1)  # [B, n]
            # radial channel strengths V_l(r) [B, n, l_max + 1]
            v_l = (nl[:, 1] * torch.exp(-nl[:, 0] * d2[..., None, None])).sum(-1)
            for start in range(0, B, walkers):
                part = slice(start, start + walkers)
                quad = get_quadrature_points(R_i[part] if per_walker else R_i, r[part],
                                             phi[k, part])  # [b, n, 12, n, 3]
                b = quad.shape[0]
                out = wf(phys_conf.replace(
                    R=R[part].repeat_interleave(n * 12, 0) if per_walker else R,
                    r=quad.reshape(-1, n, 3),
                    mol_idx=phys_conf.mol_idx[part].repeat_interleave(n * 12)))
                sign, log = out.sign.view(b, n, 12), out.log.view(b, n, 12)
                ratio = (den_sign[part, None, None] * sign
                         * torch.exp(log - den_log[part, None, None]))
                proj = ratio @ legendre_values  # [b, n, l_max + 1]
                total[part] += (v_l[part] * channel_weights * proj).sum((-1, -2))
        return total
