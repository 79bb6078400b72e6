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
    """The nuclear repulsion of ``R`` ``[n_nuc, 3]`` (or per walker ``[B, n_nuc, 3]``)."""
    i, j = triu_pairs(len(charges), device=R.device)
    return (charges[i] * charges[j] / pairwise_self_distance(R)).sum(-1)


def coulomb_force(r1, r2, c1, c2, remove_self_int: bool = False) -> torch.Tensor:
    """Coulomb force ``[..., n1, 3]`` on the particles ``r1`` ``[..., n1, 3]``
    (charges ``c1``) due to the particles ``r2`` ``[..., n2, 3]`` (charges
    ``c2``), the pairs i = j left out with ``remove_self_int``
    (``deepqmc_tpu.physics.coulomb_force``, with leading batch axes)."""
    d = r1[..., :, None, :] - r2[..., None, :, :]
    dist = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    pair_force = (c1[:, None] * c2[None])[..., None] * d / dist**3
    if remove_self_int:
        eye = torch.eye(r1.shape[-2], r2.shape[-2], dtype=torch.bool, device=d.device)
        pair_force = pair_force.masked_fill(eye[..., None], 0)
    return pair_force.sum(-2)


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


SPIN_CHUNK = 8192  # swapped configurations per forward of evaluate_spin


def evaluate_spin(hamil, wf, phys_conf, chunk: int = SPIN_CHUNK):
    """Local S^2 ``[B]`` of the walkers ``phys_conf`` (``r`` ``[B, n, 3]``)
    from the opposite-spin swaps, as ``deepqmc_tpu.physics.evaluate_spin``:
    S^2_loc = S_z (S_z + 1) + n_min - sum_ij psi(P_ij r) / psi(r), P_ij
    exchanging up electron i and down electron j.

    The walkers and their ``n_up * n_down`` swaps go through plain forwards of
    ``wf`` as one ``[B * (1 + n_up * n_down)]`` batch, cut into chunks of
    ``chunk`` configurations.  With no electron of one spin it returns the
    constant part, as the JAX package does.
    """
    n_up, n_down = hamil.n_up, hamil.n_down
    na, nb = max(n_up, n_down), min(n_up, n_down)
    s2_base = (na - nb) / 2 * ((na - nb) / 2 + 1) + nb
    r = phys_conf.r
    B, n = r.shape[:2]
    if nb == 0:
        return torch.full((B,), s2_base, dtype=r.dtype, device=r.device)
    ii, jj = torch.meshgrid(torch.arange(n_up), torch.arange(n_up, n), indexing='ij')
    perm = torch.arange(n).repeat(n_up * n_down + 1, 1)  # row 0: no swap
    rows = torch.arange(1, n_up * n_down + 1)
    perm[rows, ii.flatten()], perm[rows, jj.flatten()] = jj.flatten(), ii.flatten()
    swapped = r[:, perm.to(r.device)].flatten(0, 1)  # [B * (1 + P), n, 3]
    mol_idx = phys_conf.mol_idx.repeat_interleave(len(perm))
    R = phys_conf.R
    R = R.repeat_interleave(len(perm), 0) if R.dim() == 3 else R  # per walker
    configs = phys_conf.replace(R=R, r=swapped, mol_idx=mol_idx)
    signs, logs = [], []
    for start in range(0, len(swapped), chunk):
        psi = wf(configs.walkers(slice(start, start + chunk)))
        signs.append(psi.sign)
        logs.append(psi.log)
    sign = torch.cat(signs).view(B, -1)
    log = torch.cat(logs).view(B, -1)
    ratios = sign[:, :1] * sign[:, 1:] * torch.exp(log[:, 1:] - log[:, :1])
    return s2_base - ratios.sum(-1)
