"""Core value types (counterpart of ``deepqmc_tpu/types.py``)."""

import dataclasses
from typing import Any, NamedTuple

import torch

__all__ = ['Psi', 'PhysicalConfiguration']


class Psi(NamedTuple):
    """Wave-function value in sign/log representation; ``log`` may be an FL."""

    sign: torch.Tensor
    log: Any


@dataclasses.dataclass
class PhysicalConfiguration:
    """Nuclear coordinates ``R`` ``[n_nuc, 3]`` (one molecule) or per walker
    ``[B, n_nuc, 3]`` (a flat batch of several molecules), electron
    coordinates ``r`` ``[B, n_elec, 3]`` (a tensor or an FL) and the molecule
    index ``mol_idx`` ``[B]`` of each walker."""

    R: torch.Tensor
    r: Any
    mol_idx: torch.Tensor

    def replace(self, **kwargs) -> 'PhysicalConfiguration':
        return dataclasses.replace(self, **kwargs)

    def flat(self) -> 'PhysicalConfiguration':
        """The walkers of a grid (``R`` ``[m, n_nuc, 3]``, ``r`` ``[m, ..., n,
        3]``, ``mol_idx`` ``[m, ...]``) as one flat batch in the grid's order,
        ``R`` per walker for m > 1 and the one geometry for m = 1."""
        m, lead, nuc = self.R.shape[0], self.r.shape[:-2], self.R.shape[1:]
        if m == 1:
            R = self.R[0]
        else:
            R = self.R.view(m, *(1,) * (len(lead) - 1), *nuc).expand(*lead, *nuc).reshape(-1, *nuc)
        return PhysicalConfiguration(R, self.r.reshape(-1, *self.r.shape[-2:]),
                                     self.mol_idx.reshape(-1))

    def state(self, s: int) -> 'PhysicalConfiguration':
        """The walkers of state ``s`` of a grid (``r`` ``[m, S, B, n, 3]``) as
        one flat batch (:meth:`flat`)."""
        return self.replace(r=self.r[:, s], mol_idx=self.mol_idx[:, s]).flat()

    def walkers(self, idx) -> 'PhysicalConfiguration':
        """The walkers ``idx`` (a slice or indices) of a flat batch; ``R``
        is taken with them where it is per walker."""
        R = self.R[idx] if self.R.dim() == 3 else self.R
        return PhysicalConfiguration(R, self.r[idx], self.mol_idx[idx])
