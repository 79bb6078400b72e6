"""The S^2 penalty's terms (counterpart of ``deepqmc_tpu/loss/spin.py``) over
a ``[mol, state, walker]`` grid of one molecule."""

import torch

from ..physics import evaluate_spin
from ..utils import masked_mean, weighted_std

__all__ = ['compute_mean_spin', 'compute_mean_spin_tangent', 'compute_spin_contributions']


def compute_spin_contributions(hamil, wfs, confs) -> torch.Tensor:
    """Local S^2 ``[1, S, B]`` of each state's walkers ``confs[s]`` under its module ``wfs[s]``."""
    with torch.no_grad():
        return torch.stack([evaluate_spin(hamil, wf, pc) for wf, pc in zip(wfs, confs)])[None]


def compute_mean_spin(spin_contributions, weight):
    """(the weighted mean S^2 over the grid, per-state ``spin/mean`` and ``spin/std``)."""
    per_state = {
        'spin/mean': (spin_contributions * weight).sum(-1) / weight.sum(-1),
        'spin/std': weighted_std(spin_contributions, weight),
    }
    return (spin_contributions * weight).mean(), per_state


def compute_mean_spin_tangent(spin_contributions, weight, log_psi_tangent, gradient_mask):
    """The covariance of S^2 with the score over the walkers the mask keeps."""
    baseline = (spin_contributions * weight).mean(-1, keepdim=True)
    return masked_mean((spin_contributions - baseline) * log_psi_tangent * weight, gradient_mask)
