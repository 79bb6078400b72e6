"""Exponential orbital envelopes (counterpart of ``deepqmc_tpu/wf/env.py``),
in the PsiFormer configuration: isotropic, one envelope per nucleus,
per-orbital exponents, separate parameters per spin, ``|zeta * r|``."""

import torch

from .. import fwdlap as fl
from .. import nn
from ..physics import norm_safe

__all__ = ['ExponentialEnvelopes']


class ExponentialEnvelopes(nn.Module):
    """Flat orbital envelopes ``[B, n_spin, n_det * n_orb]`` per spin, det-major.

    pi and zeta start at one, as the preset's ``init_to_ones=True`` does.
    """

    def __init__(self, hamil, n_determinants):
        super().__init__('exponential_envelopes')
        self.n_up = hamil.n_up
        shape = (n_determinants * (hamil.n_up + hamil.n_down), hamil.n_nuc)
        for spin in ('up', 'down'):
            setattr(self, f'pi_{spin}', torch.nn.Parameter(torch.ones(shape)))
            setattr(self, f'zetas_{spin}', torch.nn.Parameter(torch.ones(shape)))

    def _one_spin(self, zeta, pi, d):
        exponent = fl.abs(zeta * d[..., None, :])  # [B, n_spin, n_orb, n_nuc]
        return (pi * fl.exp(-exponent)).sum(-1)

    def forward(self, r, R):
        d = norm_safe(r[..., :, None, :] - R)  # [B, n_el, n_nuc]
        return (
            self._one_spin(self.zetas_up, self.pi_up, d[..., : self.n_up, :]),
            self._one_spin(self.zetas_down, self.pi_down, d[..., self.n_up :, :]),
        )
