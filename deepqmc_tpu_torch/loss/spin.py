"""The S^2 penalty's terms (counterpart of ``deepqmc_tpu/loss/spin.py``) over
a ``[mol, state, walker]`` grid, its statistics over the global walker axis."""

import torch

from ..parallel import all_device_mean, all_device_sum
from ..physics import evaluate_spin
from .energy import masked_mean

__all__ = ['compute_mean_spin', 'compute_mean_spin_tangent', 'compute_spin_contributions']


def compute_spin_contributions(hamil, wfs, confs, n_mol: int = 1) -> torch.Tensor:
    """Local S^2 ``[m, S, B]`` of each state's walkers ``confs[s]`` (a flat
    batch of ``n_mol`` molecules' walkers) under its module ``wfs[s]``."""
    with torch.no_grad():
        spin = torch.stack([evaluate_spin(hamil, wf, pc) for wf, pc in zip(wfs, confs)])
    return spin.unflatten(-1, (n_mol, -1)).transpose(0, 1)


def _weighted_std(x, weights):
    """The population standard deviation of ``x`` over the walkers under ``weights``."""
    norm = all_device_sum(weights, -1)
    mean = all_device_sum(x * weights, -1, keepdim=True) / norm[..., None]
    return torch.sqrt(all_device_sum((x - mean) ** 2 * weights, -1) / norm)


def compute_mean_spin(spin_contributions, weight):
    """(the weighted mean S^2 over the grid, per-state ``spin/mean`` and ``spin/std``)."""
    per_state = {
        'spin/mean': all_device_sum(spin_contributions * weight, -1) / all_device_sum(weight, -1),
        'spin/std': _weighted_std(spin_contributions, weight),
    }
    return all_device_mean(spin_contributions * weight), per_state


def compute_mean_spin_tangent(spin_contributions, weight, log_psi_tangent, gradient_mask):
    """The covariance of S^2 with the score over the walkers the mask keeps."""
    baseline = all_device_mean(spin_contributions * weight, -1, keepdim=True)
    return masked_mean((spin_contributions - baseline) * log_psi_tangent * weight, gradient_mask)
