"""The overlap penalty of penalty-method excited states (counterpart of
``deepqmc_tpu/loss/overlap.py``).

The grids keep the JAX package's molecule axis in front: the
ratios are ``R[mol, i, j, walker] = psi_i / psi_j`` at walkers drawn from
``psi_j^2``, the one-sided overlaps ``S[mol, i, j]`` their weighted means, and
the penalty is the sum over pairs i < j of the squared sign-consistent
geometric mean of ``S`` and ``S^T``, averaged over the molecules.  The ratio
forwards are plain forwards of each state's module under ``no_grad``, one
over the flat batch of every molecule's and state's walkers: only the
sampled state is differentiated, through :meth:`OverlapPenalty.tangent`.
The means over the walkers are over the global walker axis.
"""

from typing import Optional

import torch

from ..parallel import all_device_mean
from ..utils import triu_flat
from .energy import masked_mean

__all__ = ['OverlapPenalty']


def _pair_upper_sum(per_mol: torch.Tensor) -> torch.Tensor:
    """The mean over molecules of the sum over the pairs of states i < j."""
    return triu_flat(per_mol).sum(-1).mean()


class OverlapPenalty:
    """Estimator, symmetrization, gradient scale and tangent of the penalty.

    ``scale`` is None, 'energy_gap', 'energy_std' or 'max_gap_std': how each
    pair's gradient is rescaled from the EWM training statistics; ``floor`` is
    the least scale factor.
    """

    def __init__(self, scale: Optional[str] = None, floor: float = 0.1):
        if scale not in (None, 'energy_gap', 'energy_std', 'max_gap_std'):
            raise ValueError(f'unknown overlap scale {scale!r}')
        self.scale = scale
        self.floor = floor

    @staticmethod
    def ratios(wfs, grid) -> torch.Tensor:
        """``R[mol, i, j, walker]`` for the state modules ``wfs`` and the
        walkers ``grid`` (``R`` ``[m, n_nuc, 3]``, ``r`` ``[m, S, B, n, 3]``):
        each state's psi on every state's walkers, shifted by that evaluation
        state's mean log|psi| over them, over the sampling state's own."""
        m, S, B = grid.r.shape[:3]
        flat = grid.flat()
        with torch.no_grad():
            psis = [wf(flat) for wf in wfs]
        log = torch.stack([p.log for p in psis]).view(S, m, S, B).transpose(0, 1)
        sign = torch.stack([p.sign for p in psis]).view(S, m, S, B).transpose(0, 1)
        log = log - all_device_mean(log, (-1, -2))[:, :, None, None]
        diag = torch.diagonal(log, dim1=1, dim2=2).transpose(-1, -2)
        sign_diag = torch.diagonal(sign, dim1=1, dim2=2).transpose(-1, -2)
        return sign * sign_diag[:, None] * torch.exp(log - diag[:, None])

    @staticmethod
    def one_sided(ratios: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """``S[mol, i, j]``: the weighted mean over the walkers of state j."""
        return all_device_mean(weight[:, None] * ratios, -1)

    @staticmethod
    def symmetrized(one_sided: torch.Tensor) -> torch.Tensor:
        """The sign-consistent geometric mean of ``S`` and ``S^T`` (0 where their signs differ)."""
        cross = one_sided * one_sided.transpose(-1, -2)
        return torch.sign(one_sided) * torch.sqrt(torch.clamp(cross, min=0.0))

    def value(self, ratios: torch.Tensor, weight: torch.Tensor):
        """(penalty, stats with the symmetrized overlap matrix ``[mol, S, S]``)."""
        s_sym = self.symmetrized(self.one_sided(ratios, weight))
        return _pair_upper_sum(s_sym**2), {'overlap/pairwise/mean': s_sym}

    def gradient_scale(self, data: dict):
        """Each pair's gradient factor from the EWMs ``data['energy_ewm']`` and
        ``data['std_ewm']`` (``[mol, S]``): NaN entries (the EWMs' warm-up) take
        neutral values, and the whole is clipped to [floor, 5]."""
        if self.scale is None:
            return torch.tensor(1.0)
        factors = []
        if self.scale in ('energy_gap', 'max_gap_std'):
            e = data['energy_ewm']
            factors.append(torch.nan_to_num((e[:, :, None] - e[:, None]).abs(), nan=1.0))
        if self.scale in ('energy_std', 'max_gap_std'):
            std = torch.nan_to_num(data['std_ewm'].mean(0), nan=5.0)
            factors.append(std[:, None])  # per evaluation state i
        combined = factors[0] if len(factors) == 1 else torch.maximum(*factors)
        return torch.clamp(combined, self.floor, 5.0)

    def tangent(self, ratios, weight, log_psi_tangent, gradient_mask, data: dict):
        """The penalty's tangent along ``log_psi_tangent`` (``T`` ``[mol, S, B]``)
        by the one-sided estimator, the pairs ordered by ``data['ordering']``
        (``[mol, S]``); linear in ``T``."""
        s_one = self.one_sided(ratios, weight)
        d_s = masked_mean(
            (ratios - s_one[..., None]) * weight[:, None] * log_psi_tangent[:, None],
            gradient_mask, dim=-1,
        )
        scale = torch.as_tensor(self.gradient_scale(data)).to(d_s)
        per_pair = 2.0 * d_s * s_one.transpose(-1, -2) * scale
        ordered = torch.stack([p[o][:, o] for p, o in zip(per_pair, data['ordering'])])
        return _pair_upper_sum(ordered)
