"""The icosahedral quadrature of the nonlocal ECP projection (counterpart of
``deepqmc_tpu/ecp/ecp_utils.py``), batched over walkers.

The 12 vertices of an icosahedron integrate spherical harmonics exactly up
to l = 5.  Each electron's sphere around the nucleus gets the vertices
turned onto the electron's direction, with a random azimuthal rotation in
[0, pi/5) that decorrelates the quadrature error across samples.
"""

import math

import numpy as np
import torch

__all__ = ['get_quadrature_points', 'get_unit_icosahedron_sph', 'random_azimuths']


def get_unit_icosahedron_sph() -> np.ndarray:
    """The 12 icosahedron vertices in spherical coordinates ``[theta, phi]``."""
    verts = [[0.0, 0.0], [math.pi, 0.0]]
    for j in range(5):
        verts.append([math.atan(2), math.pi / 5 * 2 * j])
        verts.append([math.pi - math.atan(2), math.pi / 5 * (2 * j - 1)])
    return np.array(verts)


def sph2cart(sph: np.ndarray) -> np.ndarray:
    """Unit vectors ``[..., 3]`` of spherical coordinates ``[..., 2]``."""
    theta, phi = sph[..., 0], sph[..., 1]
    return np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
                    axis=-1)


def rot_y(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([torch.stack([c, zero, s], -1), torch.stack([zero, one, zero], -1),
                        torch.stack([-s, zero, c], -1)], -2)


def rot_z(phi: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(phi), torch.sin(phi)
    zero, one = torch.zeros_like(phi), torch.ones_like(phi)
    return torch.stack([torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def random_azimuths(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Azimuthal rotations uniform in [0, pi/5), one per (walker, electron),
    drawn from ``gen`` on its device."""
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype) * (math.pi / 5)


def get_quadrature_points(nucleus: torch.Tensor, r: torch.Tensor,
                          phi_random: torch.Tensor) -> torch.Tensor:
    """Electron configurations ``[B, n, 12, n, 3]``: for walker b and electron
    i, the 12 copies of ``r[b]`` with electron i moved to each vertex on its
    sphere around ``nucleus`` ``[3]`` (or per walker ``[B, 3]``), turned by
    ``phi_random`` ``[B, n]``."""
    B, n, _ = r.shape
    nucleus = nucleus if nucleus.dim() == 1 else nucleus[:, None]
    rel = r - nucleus
    norm = torch.linalg.vector_norm(rel, dim=-1)
    theta = torch.arccos(torch.clamp(rel[..., 2] / norm, -1.0, 1.0))
    phi = torch.atan2(rel[..., 1], rel[..., 0])
    rot = rot_z(phi) @ rot_y(theta) @ rot_z(phi_random)  # [B, n, 3, 3]
    vertices = torch.as_tensor(sph2cart(get_unit_icosahedron_sph()), dtype=r.dtype,
                               device=r.device)  # [12, 3]
    rotated = norm[..., None, None] * torch.einsum('bnac,vc->bnva', rot, vertices) + nucleus[..., None, :]
    is_moved = torch.eye(n, dtype=torch.bool, device=r.device)[:, None, :, None]  # [n, 1, n, 1]
    base = r[:, None, None].expand(B, n, 12, n, 3)
    return torch.where(is_moved, rotated[:, :, :, None, :], base)
