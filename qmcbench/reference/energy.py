"""The local energy of a molecule as plain PyTorch.

E_loc = -1/2 (lap log|psi| + |grad log|psi||^2) - sum_iI Z_I / |r_i - R_I|
        + sum_i<j 1 / |r_i - r_j| + sum_I<J Z_I Z_J / |R_I - R_J|

The Laplacian is the trace of the Hessian of log|psi| by forward-over-reverse
differentiation (``torch.func``), one walker at a time under ``vmap``, in
chunks of walkers so that it fits beside whatever else is on the card.
"""

import torch

from . import nets

__all__ = ['local_energy', 'potential']


def potential(r, R, Z):
    """The Coulomb potential energy of each walker ``[B]``: electron-nucleus,
    electron-electron and nucleus-nucleus."""
    n, n_nuc = r.shape[1], len(R)
    v_ne = -(Z / torch.linalg.vector_norm(r[:, :, None] - R, dim=-1)).sum((-1, -2))
    i, j = torch.triu_indices(n, n, 1, device=r.device)
    v_ee = (1 / torch.linalg.vector_norm(r[:, i] - r[:, j], dim=-1)).sum(-1)
    I, J = torch.triu_indices(n_nuc, n_nuc, 1, device=r.device)
    v_nn = (Z[I] * Z[J] / torch.linalg.vector_norm(R[I] - R[J], dim=-1)).sum()
    return v_ne, v_ee, v_nn


def _kinetic_terms(P, cfg, r, R):
    B, n, _ = r.shape

    def log_abs(x):
        return nets.log_psi(P, cfg, x.view(1, n, 3), R)[1][0]

    grad = torch.func.grad(log_abs)
    eye = torch.eye(3 * n, dtype=r.dtype, device=r.device)

    def one(x):
        g, hess = torch.func.vmap(lambda v: torch.func.jvp(grad, (x,), (v,)))(eye)
        return torch.diagonal(hess).sum(), g[0]

    lap, g = torch.func.vmap(one)(r.reshape(B, 3 * n))
    return lap, (g * g).sum(-1)


def local_energy(P, cfg, r, R, Z, chunk=128, with_scale=False):
    """``E_loc`` ``[B]`` of the walkers ``r`` ``[B, n, 3]`` around the nuclei
    ``R`` (charges ``Z``), with the parameters ``P``; with ``with_scale`` also
    each walker's sum of the terms' magnitudes, 1 + |lap|/2 + |grad|^2/2 +
    the potential's terms, the scale of its rounding error."""
    with torch.no_grad():
        parts = [_kinetic_terms(P, cfg, r[i:i + chunk], R) for i in range(0, len(r), chunk)]
        lap, g2 = (torch.cat(x) for x in zip(*parts))
        v_ne, v_ee, v_nn = potential(r, R, Z)
        E = -0.5 * (lap + g2) + v_ne + v_ee + v_nn
        scale = 1 + 0.5 * (lap.abs() + g2) - v_ne + v_ee + v_nn
        return (E, scale) if with_scale else E
