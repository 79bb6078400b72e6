"""Local energies and the terms of the VMC energy gradient (counterpart of
``deepqmc_tpu/loss/energy.py``, one molecule).

The local energy runs through the forward Laplacian (and so the kernels on the
card) with autograd off: the estimator never differentiates the Hamiltonian,
and the kernels have no backward.  The gradient of the mean energy is linear in
the per-walker tangents ``T = d log|psi|``; :func:`compute_mean_energy_cotangent`
is that linear map's transpose, the per-walker coefficient that the one
backward pass of ``log|psi|`` pulls back to the parameters.
"""

import torch

from ..parallel import all_device_mean
from ..utils import masked_mean

__all__ = [
    'compute_local_energy', 'compute_mean_energy', 'compute_mean_energy_cotangent',
    'compute_mean_energy_tangent',
]


def compute_local_energy(hamil, wf, phys_conf):
    """Local energies ``[B]`` of the walkers and the means of the Hamiltonian's terms."""
    with torch.no_grad():
        local_energy, hamil_stats = hamil.local_energy(wf, phys_conf)
    return local_energy, {k: v.mean() for k, v in hamil_stats.items()}


def compute_mean_energy(local_energy: torch.Tensor, weight: torch.Tensor):
    return all_device_mean(local_energy * weight), {}


def compute_mean_energy_tangent(local_energy, weight, log_psi_tangent, gradient_mask):
    """Control-variate VMC gradient along ``log_psi_tangent``:
    E[(E_loc - E_mean) * T * w] over the walkers the mask keeps, the baseline
    taken per batch of the last axis (per electronic state of a grid)."""
    baseline = (local_energy * weight).mean(-1, keepdim=True)
    return masked_mean((local_energy - baseline) * log_psi_tangent * weight, gradient_mask)


def compute_mean_energy_cotangent(local_energy, weight, gradient_mask):
    """Per-walker coefficient ``c`` with ``compute_mean_energy_tangent(..., T, ...)
    == (c * T).sum()`` for every ``T``: mask * (E - baseline) * w / sum(mask)."""
    baseline = all_device_mean(local_energy * weight)
    coeff = (local_energy - baseline) * weight
    return torch.where(gradient_mask, coeff, torch.zeros_like(coeff)) / gradient_mask.sum()
