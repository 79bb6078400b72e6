"""Electronic and nuclear cusp corrections (counterpart of
``deepqmc_tpu/wf/cusp.py``): ``ElectronicCuspAsymptotic`` and
``NuclearCuspAsymptotic`` with the ``PsiformerCusp`` or ``DeepQMCCusp``
pair function."""

from typing import Optional

import torch

from .. import nn
from ..physics import norm_safe, triu_pairs

__all__ = ['DeepQMCCusp', 'ElectronicCuspAsymptotic', 'NuclearCuspAsymptotic', 'PsiformerCusp']


class PsiformerCusp:
    """scale * alpha^2 / (alpha + r) summed over pairs, negated."""

    def __call__(self, scale, alpha, dist):
        return -((scale * alpha**2) / (alpha + dist)).sum(-1)


class DeepQMCCusp:
    """scale / (alpha * (1 + alpha * r)) summed over pairs, negated."""

    def __call__(self, scale, alpha, dist):
        return -(scale / (alpha * (1 + alpha * dist))).sum(-1)


class CuspAsymptotic(nn.Module):
    """What the cusps share: the pair function and each channel's alpha, a
    parameter ``{label}_alpha`` with ``trainable_alpha``, else a constant
    (a buffer outside the ``state_dict``, as the JAX package keeps it out of
    the parameters)."""

    def __init__(self, *, cusp_function, trainable_alpha, name: Optional[str] = None):
        super().__init__()
        self.cusp_function = cusp_function
        self.trainable_alpha = trainable_alpha

    def _add_alpha(self, value, label):
        value = torch.tensor(float(value))
        if self.trainable_alpha:
            setattr(self, f'{label}_alpha', torch.nn.Parameter(value))
        else:
            self.register_buffer(f'{label}_alpha', value, persistent=False)


class ElectronicCuspAsymptotic(CuspAsymptotic):
    """Additive log-psi term for the same-spin and opposite-spin e-e cusps.

    An empty pair channel (one electron of a spin) adds nothing and has no
    parameter, as in the JAX package.
    """

    def __init__(self, n_up, n_down, *, same_scale, anti_scale, alpha=1.0, cusp_function,
                 trainable_alpha, name: Optional[str] = None):
        super().__init__(cusp_function=cusp_function, trainable_alpha=trainable_alpha)
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
                self._add_alpha(alpha, label)
                self.register_buffer(f'{label}_i', i, persistent=False)
                self.register_buffer(f'{label}_j', j, persistent=False)
                self.channels.append((label, scale))

    def forward(self, r):
        total = 0
        for label, scale in self.channels:
            i, j = getattr(self, f'{label}_i'), getattr(self, f'{label}_j')
            dists = norm_safe(r[..., i, :] - r[..., j, :])
            total = total + self.cusp_function(scale, getattr(self, f'{label}_alpha'), dists)
        return total


class NuclearCuspAsymptotic(CuspAsymptotic):
    """Additive log-psi term for the electron-nucleus cusps, the nuclear
    charge the scale of each pair."""

    def __init__(self, nuclear_charges, *, alpha=1.0, cusp_function, trainable_alpha,
                 name: Optional[str] = None):
        super().__init__(cusp_function=cusp_function, trainable_alpha=trainable_alpha)
        charges = torch.as_tensor([float(z) for z in nuclear_charges], dtype=torch.float64)
        self.register_buffer('charges', charges, persistent=False)
        self._add_alpha(alpha, 'nuc')

    def forward(self, dists):
        """``dists`` ``[B, n_el, n_nuc]`` -> ``[B]``."""
        scale = self.charges.expand(dists.shape[-2], -1).flatten()
        return self.cusp_function(scale, self.nuc_alpha, dists.flatten(-2))
