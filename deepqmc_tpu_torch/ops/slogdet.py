"""Log-determinants (counterpart of ``deepqmc_tpu/ops/slogdet.py``).

:func:`slogdet` takes square matrices ``[..., n, n]``.  The ansatz assembles
its Slater matrices flat, ``[..., n, n_det * n]`` with determinant-major
columns; :func:`slogdet_flat` unpacks them to ``[..., n_det, n, n]``.  Their
forward-Laplacian rules are ``fwdlap.slogdet`` and ``fwdlap.slogdet_flat``.
"""

import torch

__all__ = ['slogdet', 'slogdet_flat', 'unflatten_dets']


def slogdet(a: torch.Tensor):
    """(sign, log|det|) of the trailing square dimensions of ``a``."""
    return torch.linalg.slogdet(a)


def unflatten_dets(a_flat: torch.Tensor, n_det: int) -> torch.Tensor:
    """[..., n, n_det * n] (det-major columns) -> [..., n_det, n, n]."""
    return a_flat.unflatten(-1, (n_det, -1)).movedim(-2, -3)


def slogdet_flat(a_flat: torch.Tensor, n_det: int):
    """Per-determinant (sign, log|det|) of a flat orbital matrix, shape [..., n_det]."""
    return torch.linalg.slogdet(unflatten_dets(a_flat, n_det))
