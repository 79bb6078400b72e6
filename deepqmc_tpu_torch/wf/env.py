"""Exponential orbital envelopes (counterpart of ``deepqmc_tpu/wf/env.py``).

Each envelope class returns the flat det-major orbital envelopes of each
spin, ``([B, n_up, n_det * n_orb], [B, n_down, n_det * n_orb])``: the row
blocks the determinants take, never concatenated.
"""

from typing import Optional

import numpy as np
import torch

from .. import fwdlap as fl
from .. import nn
from ..nn.core import array_init, current_generator, ones_init, variance_scaling
from ..physics import norm_safe

__all__ = ['ExponentialEnvelopes', 'SimplifiedNucleusDependentEnvelopes']


def _ones_plus_variance_scaling(gen, shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype) + variance_scaling(gen, shape, dtype=dtype)


class ExponentialEnvelopes(nn.Module):
    """Per-nucleus (per-shell with ``per_shell``) exponential envelopes: orbital
    o of electron i is ``sum_e pi[o, e] exp(-|zeta_e (r_i - R_e)|)``.

    ``isotropic`` takes a scalar zeta (else a 3x3 matrix), ``per_orbital_exponent``
    one zeta per orbital, ``spin_restricted`` one set of parameters for both
    spins, ``init_to_ones`` starts pi and zeta at one (else pi at one plus a
    variance-scaling draw and zeta at Z / shell), ``softplus_zeta`` takes
    ``softplus(zeta) r`` for the exponent.
    """

    def __init__(self, hamil, n_determinants, *, isotropic, per_shell, per_orbital_exponent,
                 spin_restricted, init_to_ones, softplus_zeta, nuc_params_from_head=False,
                 name: Optional[str] = None):
        super().__init__()
        shells = []
        for i, (z, n_shell, n_ecp_shell) in enumerate(
                zip(hamil.mol.charges, hamil.mol_shells, hamil.mol_ecp_shells)):
            for k in range(n_ecp_shell, n_shell if per_shell else n_ecp_shell + 1):
                shells.append((i, float(z) / (k + 1)))
        center_idx, zetas = zip(*shells)
        self.register_buffer('center_idx', torch.tensor(center_idx), persistent=False)
        self.isotropic, self.per_orbital_exponent = isotropic, per_orbital_exponent
        self.spin_restricted, self.softplus_zeta = spin_restricted, softplus_zeta
        self.n_up = hamil.n_up
        n_orb = n_determinants * (hamil.n_up + hamil.n_down)
        zetas = np.array(zetas)
        if per_orbital_exponent:
            zetas = np.tile(zetas[None], (n_orb, 1))  # [n_orb, n_env]
        if not isotropic:
            zetas = zetas[..., None, None] * np.eye(3)
        gen = current_generator() if not init_to_ones else None
        pi_init = ones_init if init_to_ones else _ones_plus_variance_scaling
        zeta_init = ones_init if init_to_ones else array_init(zetas)
        spins = [''] if spin_restricted else ['_up', '_down']
        for spin in spins:
            setattr(self, f'pi{spin}', torch.nn.Parameter(pi_init(gen, (n_orb, len(center_idx)))))
            setattr(self, f'zetas{spin}', torch.nn.Parameter(zeta_init(gen, zetas.shape)))

    def _one_spin(self, zeta, pi, d):
        """``d`` ``[B, n_s, n_env, 3]`` -> ``[B, n_s, n_orb]``."""
        if self.isotropic:
            d = norm_safe(d)  # [B, n_s, n_env]
            if self.per_orbital_exponent:
                d = d[..., None, :]  # [B, n_s, 1, n_env]
            exponent = fl.softplus(zeta) * d if self.softplus_zeta else fl.abs(zeta * d)
        else:
            # |zeta_e d|, zeta [(n_orb,) n_env, 3, 3]: an einsum in the JAX package
            dd = d[..., None, :, None, :] if self.per_orbital_exponent else d[..., :, None, :]
            exponent = norm_safe(fl.dot(dd, zeta))
        if not self.per_orbital_exponent:
            exponent = exponent[..., None, :]  # [B, n_s, 1, n_env]
        return (pi * fl.exp(-exponent)).sum(-1)

    def forward(self, r, R, nuc_params=None):
        n = self.n_up
        d = r[..., :, None, :] - R[..., self.center_idx, :]  # [B, n_el, n_env, 3]
        if self.spin_restricted:
            return (self._one_spin(self.zetas, self.pi, d[..., :n, :, :]),
                    self._one_spin(self.zetas, self.pi, d[..., n:, :, :]))
        return (self._one_spin(self.zetas_up, self.pi_up, d[..., :n, :, :]),
                self._one_spin(self.zetas_down, self.pi_down, d[..., n:, :, :]))


class SimplifiedNucleusDependentEnvelopes(nn.Module):
    """Envelopes whose zeta (and, without ``fixed_pi``, pi) come per nucleus
    from the nuclear GNN head (``nuc_params``, for transferable wave
    functions): ``n_envelope_per_nucleus`` envelopes per nucleus, determinant
    and (with ``per_orbital_exponent``) orbital.  Without a head
    (``nuc_params_from_head`` False) zeta is a parameter of ones; pi needs
    the head unless ``fixed_pi``."""

    def __init__(self, hamil, n_determinants, *, n_envelope_per_nucleus, per_orbital_exponent,
                 fixed_pi, nuc_params_from_head=False, name: Optional[str] = None):
        super().__init__()
        self.n_up = hamil.n_up
        self.n_env = n_envelope_per_nucleus
        self.n_nuc = hamil.n_nuc
        self.n_orb = hamil.n_up + hamil.n_down
        self.n_det = n_determinants
        self.per_orbital_exponent, self.fixed_pi = per_orbital_exponent, fixed_pi
        if not fixed_pi and not nuc_params_from_head:
            raise ValueError('SimplifiedNucleusDependentEnvelopes without fixed_pi takes pi '
                             'from a nuclear GNN head: the omni factory has none')
        pi_shape = (self.n_nuc, self.n_orb, self.n_det, self.n_env)
        self.register_buffer('pis', torch.ones(pi_shape), persistent=False)
        if not nuc_params_from_head:
            shape = ((self.n_nuc, self.n_orb, self.n_det, self.n_env) if per_orbital_exponent
                     else (self.n_nuc, self.n_det, self.n_env))
            self.zetas_up = torch.nn.Parameter(torch.ones(shape))
            self.zetas_down = torch.nn.Parameter(torch.ones(shape))

    def _reshape(self, x, orbital_dimension):
        """A head's ``[B, n_nuc, *shape]`` as ``[B, n_nuc, (n_orb,) n_det, n_env]``."""
        shape = ((-1, self.n_orb, self.n_det, self.n_env) if orbital_dimension
                 else (-1, self.n_det, self.n_env))
        return x.flatten(-(x.dim() - 1), -1).unflatten(-1, shape)

    def _one_spin(self, zeta, pi, distance):
        """``distance`` ``[B, n_s, n_nuc]`` -> ``[B, n_s, n_det * n_orb]``;
        ``zeta`` and ``pi`` have a walker axis when they come from the head."""
        def per_electron(x, batched):
            return x[..., None, :, :, :, :] if batched else x

        pi = per_electron(pi.transpose(-3, -2), pi.dim() == 5)  # [.., n_nuc, n_det, n_orb, n_env]
        if self.per_orbital_exponent:
            zeta = per_electron(zeta.transpose(-3, -2), zeta.dim() == 5)
            exponent = fl.abs(distance[..., None, None, None] * zeta)
        else:
            zeta = zeta[..., None, :, :, :] if zeta.dim() == 4 else zeta
            exponent = fl.abs(distance[..., None, None] * zeta)[..., None, :]
        orbs = (pi * fl.exp(-exponent)).sum(-1).sum(-3)  # [B, n_s, n_det, n_orb]
        return orbs.flatten(-2)

    def forward(self, r, R, nuc_params=None):
        distance = norm_safe(r[..., :, None, :] - R)  # [B, n_el, n_nuc]
        if nuc_params is None:
            zetas = (self.zetas_up, self.zetas_down)
        else:
            zetas = tuple(self._reshape(nuc_params[k], self.per_orbital_exponent)
                          for k in ('zetas_up', 'zetas_down'))
        pis = ((self.pis, self.pis) if self.fixed_pi
               else tuple(self._reshape(nuc_params[k], True) for k in ('pis_up', 'pis_down')))
        n = self.n_up
        return (self._one_spin(zetas[0], pis[0], distance[..., :n, :]),
                self._one_spin(zetas[1], pis[1], distance[..., n:, :]))
