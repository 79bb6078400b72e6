"""Gaussian-type atomic orbitals at electron positions (counterpart of
``deepqmc_tpu/pretrain/gto.py``).

The ragged per-shell structure is flattened at construction into dense padded
tables (shells x primitives, AOs x angular powers), and the whole basis is
evaluated in one vectorised pass.  The normalisation matches
:mod:`.integrals`, so SCF MO coefficients contract directly with these AO
values.  The JAX package keeps the contraction coefficients and exponents as
parameters that pretraining never updates; here they are buffers: the module
has no parameters.
"""

import numpy as np
import torch

from .integrals import cartesian_angulars, double_factorial

__all__ = ['GTOBasis']


class GTOBasis(torch.nn.Module):
    """The full AO basis of a molecule, evaluated at electron positions.

    Args:
        centers: ``[n_centers, 3]`` nuclear coordinates.
        shells: list of ``(atom_idx, (l, coeffs, zetas))`` contracted shells.
    """

    def __init__(self, centers, shells):
        super().__init__()
        # dense shell table: [n_shell, n_prim] zero-padded primitives
        n_prim = max(len(zetas) for _, (_, _, zetas) in shells)
        zeta_tab = np.ones((len(shells), n_prim))
        coeff_tab = np.zeros((len(shells), n_prim))
        ls, shell_centers = [], []
        for s, (atom, (l, coeffs, zetas)) in enumerate(shells):
            zeta_tab[s, :len(zetas)] = zetas
            coeff_tab[s, :len(zetas)] = coeffs
            ls.append(l)
            shell_centers.append(atom)
        # dense AO table: every cartesian component of every shell
        ao_powers, ao_shell = [], []
        for s, l in enumerate(ls):
            for powers in cartesian_angulars(l):
                ao_powers.append(powers)
                ao_shell.append(s)
        ao_powers = np.asarray(ao_powers)  # [n_ao, 3]
        anorms = 1.0 / np.sqrt(np.vectorize(double_factorial)(2 * ao_powers - 1).prod(-1))
        ls = np.asarray(ls)
        rnorms = (2 * zeta_tab / np.pi) ** (3 / 4) * (4 * zeta_tab) ** (ls[:, None] / 2)

        def buffer(name, value, dtype=torch.float64):
            self.register_buffer(name, torch.as_tensor(value, dtype=dtype), persistent=False)

        buffer('centers', np.asarray(centers, dtype=float))
        buffer('ao_powers', ao_powers.astype(float))
        buffer('ao_shell', ao_shell, torch.long)  # [n_ao] -> shell index
        buffer('shell_center', shell_centers, torch.long)  # [n_shell] -> atom index
        buffer('anorms', anorms)  # [n_ao]
        buffer('rnorms', rnorms)  # [n_shell, n_prim]
        buffer('zetas', zeta_tab)
        buffer('coeffs', coeff_tab)

    def forward(self, diffs):
        """diffs: ``[..., n_elec, n_centers, 4]`` (difference vectors and squared
        norm); returns the AO values ``[..., n_elec, n_ao]``."""
        r2 = diffs[..., self.shell_center, 3]  # [..., n_shell]
        exps = self.rnorms * torch.exp(-torch.abs(self.zetas * r2[..., None]))
        radials = (self.coeffs * exps).sum(-1)  # [..., n_shell]
        rs = diffs[..., self.shell_center[self.ao_shell], :3]  # [..., n_ao, 3]
        angulars = torch.pow(rs, self.ao_powers).prod(-1)  # [..., n_ao]
        return self.anorms * angulars * radials[..., self.ao_shell]
