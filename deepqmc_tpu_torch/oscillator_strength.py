"""Oscillator strengths from logged local energies and wave-function ratios
(counterpart of ``deepqmc_tpu/oscillator_strength.py``), for the offline
analysis of a run of several electronic states.

The estimator is the dipole-times-ratio one of the observable monitor
(:func:`.observable.oscillator_strength_statistics`), built on a small
first-order error-propagation algebra over ``(mean, err)`` estimates.  Its
error algebra is the JAX module's, which differs from the monitor's: the 2/3
prefactor enters the error of f once more through |f| (so these errors are
2/3 of the monitor's), and the zero-gap diagonal's error is NaN (0/0), where
the monitor gives 0.  A comparison of the two must expect both differences.
"""

from typing import NamedTuple, Optional

import torch

__all__ = ['compute_oscillator_strength']


class Estimate(NamedTuple):
    """A value with its statistical uncertainty."""

    mean: torch.Tensor
    err: torch.Tensor

    @property
    def rel_err(self):
        return self.err / self.mean


def _mc_estimate(samples: torch.Tensor, dim: int, mask=None) -> Estimate:
    """Monte Carlo mean and standard error along ``dim`` (over the entries
    ``mask`` keeps, the error's count all of them, as the JAX module's)."""
    n = samples.shape[dim]
    if mask is None:
        mean = samples.mean(dim)
        std = samples.std(dim, correction=0)
    else:
        mask = mask.expand_as(samples)
        count = mask.sum(dim)
        mean = torch.where(mask, samples, 0).sum(dim) / count
        std = torch.sqrt(torch.where(mask, (samples - mean.unsqueeze(dim)) ** 2, 0).sum(dim)
                         / count)
    return Estimate(mean, std / n**0.5)


def _product(a: Estimate, b: Estimate) -> Estimate:
    """First-order error propagation through an elementwise product."""
    mean = a.mean * b.mean
    return Estimate(mean, mean.abs() * torch.hypot(a.rel_err, b.rel_err))


def _sum_last(a: Estimate) -> Estimate:
    """Sum over the trailing axis; errors add in quadrature."""
    return Estimate(a.mean.sum(-1), torch.sqrt((a.err**2).sum(-1)))


def compute_oscillator_strength(
    local_energies: torch.Tensor,
    ratios: torch.Tensor,
    rs: torch.Tensor,
    local_energies_mask: Optional[torch.Tensor] = None,
    ratios_mask: Optional[torch.Tensor] = None,
):
    """Oscillator strengths, transition dipole moments, excitation energies.

    Shapes: ``local_energies`` ``[state, walker]``, ``ratios`` ``[state,
    state, walker]`` (``ratios[i, j]`` = psi_i / psi_j at the walkers of j),
    ``rs`` ``[state, walker, n_elec, 3]``.  Returns three ``(mean, err)``
    pairs: the oscillator strength, the transition dipole norm and the
    excitation energy, each ``[state, state]``.
    """
    # pairwise excitation energies Delta_ij = E_j - E_i
    energy = _mc_estimate(local_energies, -1, local_energies_mask)
    excitation = Estimate(energy.mean[None, :] - energy.mean[:, None],
                          torch.hypot(energy.err[None, :], energy.err[:, None]))
    # transition dipoles D[i, j, a] = < (-sum_e r_e^a) psi_i / psi_j >_{r ~ psi_j^2}
    dipole_samples = -rs.sum(-2) * ratios[..., None]
    dipole = _mc_estimate(dipole_samples, -2,
                          None if ratios_mask is None else ratios_mask[..., None])
    # dipole strength S_ij = sum_a D_ij^a D_ji^a and its root, the transition dipole moment
    strength = _sum_last(_product(dipole, Estimate(*(x.transpose(0, 1) for x in dipole))))
    tdm = Estimate(torch.sqrt(strength.mean),
                   0.5 * torch.sqrt(strength.mean) * strength.rel_err)
    # f_ij = 2/3 Delta_ij S_ij, the 2/3 in the error once more through |f|
    f_mean = (2 / 3) * excitation.mean * strength.mean
    oscillator = Estimate(
        f_mean, (2 / 3) * f_mean.abs() * torch.hypot(excitation.rel_err, strength.rel_err))
    return ((oscillator.mean, oscillator.err), (tdm.mean, tdm.err),
            (excitation.mean, excitation.err))
