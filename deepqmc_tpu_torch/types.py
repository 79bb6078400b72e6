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
    """Nuclear coordinates ``R`` ``[n_nuc, 3]`` (one molecule), electron
    coordinates ``r`` ``[B, n_elec, 3]`` (a tensor or an FL) and the molecule
    index ``mol_idx`` ``[B]`` of each walker."""

    R: torch.Tensor
    r: Any
    mol_idx: torch.Tensor

    def replace(self, **kwargs) -> 'PhysicalConfiguration':
        return dataclasses.replace(self, **kwargs)
