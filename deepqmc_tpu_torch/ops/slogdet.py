"""Flat-layout log-determinant (counterpart of ``deepqmc_tpu/ops/slogdet.py``).

The ansatz assembles its Slater matrices flat, ``[..., n, n_det * n]`` with
determinant-major columns; this module unpacks them to ``[..., n_det, n, n]``.
"""

import torch

__all__ = ['slogdet_flat', 'unflatten_dets']


def unflatten_dets(a_flat: torch.Tensor, n_det: int) -> torch.Tensor:
    """[..., n, n_det * n] (det-major columns) -> [..., n_det, n, n]."""
    return a_flat.unflatten(-1, (n_det, -1)).movedim(-2, -3)


def slogdet_flat(a_flat: torch.Tensor, n_det: int):
    """Per-determinant (sign, log|det|) of a flat orbital matrix, shape [..., n_det]."""
    return torch.linalg.slogdet(unflatten_dets(a_flat, n_det))
