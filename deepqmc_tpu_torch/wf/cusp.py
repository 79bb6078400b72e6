"""Electronic cusp correction (counterpart of ``deepqmc_tpu/wf/cusp.py``):
``ElectronicCuspAsymptotic`` with the ``PsiformerCusp`` or ``DeepQMCCusp``
pair function."""

import torch

from .. import nn
from ..physics import norm_safe, triu_pairs

__all__ = ['DeepQMCCusp', 'ElectronicCuspAsymptotic', 'PsiformerCusp']


class PsiformerCusp:
    """scale * alpha^2 / (alpha + r) summed over pairs, negated."""

    def __call__(self, scale, alpha, dist):
        return -((scale * alpha**2) / (alpha + dist)).sum(-1)


class DeepQMCCusp:
    """scale / (alpha * (1 + alpha * r)) summed over pairs, negated."""

    def __call__(self, scale, alpha, dist):
        return -(scale / (alpha * (1 + alpha * dist))).sum(-1)


class ElectronicCuspAsymptotic(nn.Module):
    """Additive log-psi term for the same-spin and opposite-spin e-e cusps.

    An empty pair channel (one electron of a spin) adds nothing and has no
    parameter, as in the JAX package.  With ``trainable_alpha=False`` each
    channel's alpha is a constant (a buffer outside the ``state_dict``), as
    the JAX package keeps it out of the parameters.
    """

    def __init__(self, n_up, n_down, *, same_scale, anti_scale, alpha=1.0, cusp_function,
                 trainable_alpha=True):
        super().__init__('electronic_cusp_asymptotic')
        iu, ju = triu_pairs(n_up)
        idn, jdn = triu_pairs(n_down)
        same = (torch.cat([iu, n_up + idn]), torch.cat([ju, n_up + jdn]))
        ia, ja = torch.meshgrid(torch.arange(n_up), n_up + torch.arange(n_down), indexing='ij')
        self.channels = []
        for label, scale, (i, j) in (
            ('same', same_scale, same),
            ('anti', anti_scale, (ia.reshape(-1), ja.reshape(-1))),
        ):
            if len(i):
                value = torch.tensor(float(alpha))
                if trainable_alpha:
                    setattr(self, f'{label}_alpha', torch.nn.Parameter(value))
                else:
                    self.register_buffer(f'{label}_alpha', value, persistent=False)
                self.register_buffer(f'{label}_i', i, persistent=False)
                self.register_buffer(f'{label}_j', j, persistent=False)
                self.channels.append((label, scale))
        self.cusp_function = cusp_function

    def forward(self, r):
        total = 0
        for label, scale in self.channels:
            i, j = getattr(self, f'{label}_i'), getattr(self, f'{label}_j')
            dists = norm_safe(r[..., i, :] - r[..., j, :])
            total = total + self.cusp_function(scale, getattr(self, f'{label}_alpha'), dists)
        return total
