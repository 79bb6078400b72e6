"""Local energies and the terms of the VMC energy gradient (counterpart of
``deepqmc_tpu/loss/energy.py``).

The local energy runs through the forward Laplacian (and so the kernels on the
card) with autograd off: the estimator never differentiates the Hamiltonian,
and the kernels have no backward.  The gradient of the mean energy is linear in
the per-walker tangents ``T = d log|psi|``; :func:`compute_mean_energy_cotangent`
is that linear map's transpose, the per-walker coefficient that the one
backward pass of ``log|psi|`` pulls back to the parameters.
"""

import torch

from .. import tracing
from ..parallel import all_device_mean, all_device_sum
from ..utils import chunk_size

__all__ = [
    'compute_local_energy', 'compute_mean_energy', 'compute_mean_energy_cotangent',
    'compute_mean_energy_tangent', 'masked_mean',
]


def compute_local_energy(hamil, wf, phys_conf, *, walker_chunk=None):
    """Local energies ``[B]`` of the walkers and each walker's terms of the
    Hamiltonian (``[B]`` each; their callers take the means they report).

    With ``walker_chunk`` the walkers go through the local energy in
    sequential chunks of the largest divisor of B at most it, which bounds
    the forward Laplacian's ``[chunk, 3n, ...]`` Jacobians; ``None`` reads
    ``DEEPQMC_TPU_ELOC_WALKER_CHUNK`` (0, no chunks), as the JAX package
    does.  The nonlocal quadrature's rotations of an ECP are drawn for the
    whole batch before it is cut, so the chunks change no number.
    """
    B = phys_conf.r.shape[0]
    size = chunk_size(B, walker_chunk, 'DEEPQMC_TPU_ELOC_WALKER_CHUNK')
    with tracing.span('local_energy'), torch.no_grad():
        phi = hamil.nl_rotations(phys_conf)
        parts = [
            hamil.local_energy(
                wf, phys_conf.walkers(slice(i, i + size)),
                phi=None if phi is None else phi[:, i:i + size])
            for i in range(0, B, size)
        ]
        local_energy = torch.cat([e for e, _ in parts])
        hamil_stats = {k: torch.cat([s[k] for _, s in parts]) for k in parts[0][1]}
    return local_energy, hamil_stats


def compute_mean_energy(local_energy: torch.Tensor, weight: torch.Tensor):
    return all_device_mean(local_energy * weight), {}


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """The sum of ``x`` where ``mask`` holds over the count of such entries,
    over ``dim`` (or all of it) of the global batch."""
    x = torch.where(mask, x, torch.zeros_like(x))
    return all_device_sum(x, dim) / all_device_sum(mask.to(x.dtype), dim)


def compute_mean_energy_tangent(local_energy, weight, log_psi_tangent, gradient_mask):
    """Control-variate VMC gradient along ``log_psi_tangent``:
    E[(E_loc - E_mean) * T * w] over the walkers the mask keeps, the baseline
    taken per batch of the last axis (per molecule and electronic state of a
    grid)."""
    baseline = all_device_mean(local_energy * weight, -1, keepdim=True)
    return masked_mean((local_energy - baseline) * log_psi_tangent * weight, gradient_mask)


def compute_mean_energy_cotangent(local_energy, weight, gradient_mask):
    """Per-walker coefficient ``c`` with ``compute_mean_energy_tangent(..., T, ...)
    == (c * T).sum()`` over the global batch for every ``T``: mask * (E -
    baseline) * w / sum(mask), the baseline per batch of the last axis."""
    baseline = all_device_mean(local_energy * weight, -1, keepdim=True)
    coeff = (local_energy - baseline) * weight
    count = all_device_sum(gradient_mask.to(coeff.dtype))
    return torch.where(gradient_mask, coeff, torch.zeros_like(coeff)) / count
