"""Pairwise geometry, Coulomb terms and the autograd Laplacian oracle
(counterpart of ``deepqmc_tpu/physics.py``)."""

import torch

from . import fwdlap as fl

__all__ = ()


def norm_safe(d):
    """Euclidean norm over the last axis with ``eps`` under the root (finite
    gradient at 0), as ``deepqmc_tpu.utils.norm(safe=True)``; ``d`` may be an FL."""
    eps = torch.finfo(d.dtype).eps
    return fl.sqrt(eps + (d * d).sum(-1))


def triu_pairs(n: int, device=None):
    """Index pairs (i, j), i < j, in ``numpy.triu_indices`` order."""
    return torch.triu_indices(n, n, 1, device=device).unbind(0)


def pairwise_self_distance(coords):
    """Distances ``[..., n(n-1)/2]`` between distinct particles of one set (safe norm)."""
    i, j = triu_pairs(coords.shape[-2], device=coords.device)
    return norm_safe(coords[..., i, :] - coords[..., j, :])


def pairwise_diffs(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Difference vectors ``c1_i - c2_j`` ``[..., i, j, 4]`` with the squared
    norm appended as a fourth channel."""
    d = c1[..., :, None, :] - c2[..., None, :, :]
    return torch.cat([d, (d * d).sum(-1, keepdim=True)], -1)


def pairwise_distance(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(c1[..., :, None, :] - c2[..., None, :, :], dim=-1)


def nuclear_energy(R: torch.Tensor, charges: torch.Tensor) -> torch.Tensor:
    i, j = triu_pairs(len(charges), device=R.device)
    return (charges[i] * charges[j] / pairwise_self_distance(R)).sum()


def electronic_potential(r: torch.Tensor) -> torch.Tensor:
    return (1 / pairwise_self_distance(r)).sum(-1)


def nuclear_potential(r: torch.Tensor, R: torch.Tensor, charges: torch.Tensor) -> torch.Tensor:
    """All-electron Coulomb potential -sum_iI Z_I / r_iI per walker."""
    return -(charges / pairwise_distance(r, R)).sum((-1, -2))


def loop_laplacian(f):
    """LaplacianFactory by nested autograd (``torch.func``): the oracle of the
    forward Laplacian, as ``deepqmc_tpu.physics.loop_laplacian``.

    ``f`` maps electrons ``[B, n, 3]`` to ``log psi`` ``[B]``; the returned
    function loops over walkers and, per walker, over the 3n coordinates.
    """

    def lap(r: torch.Tensor):
        B, n, _ = r.shape

        def f_one(x):
            return f(x.reshape(1, n, 3))[0]

        grad_f = torch.func.grad(f_one)
        eye = torch.eye(3 * n, dtype=r.dtype, device=r.device)
        laps, grads = [], []
        for x in r.reshape(B, 3 * n):
            grads.append(grad_f(x))
            laps.append(sum(torch.func.jvp(grad_f, (x,), (e,))[1][i] for i, e in enumerate(eye)))
        return torch.stack(laps), torch.stack(grads)

    return lap
