"""Molecular Hamiltonian: walker initialisation and the local energy
(counterpart of ``deepqmc_tpu/hamil.py``), all-electron or with effective
core potentials (:mod:`.ecp`)."""

from typing import Optional

import numpy as np
import torch

from .ecp import GaussianTypeECP
from .ecp.ecp_utils import random_azimuths
from .fwdlap import forward_laplacian
from .molecule import Molecule
from .physics import electronic_potential, nuclear_energy, nuclear_potential
from .types import PhysicalConfiguration

__all__ = ['MolecularHamiltonian']


def get_shell(z) -> int:
    """The number of (at least partly) occupied shells for ``z`` electrons."""
    n = 0
    while n * (n + 1) * (2 * n + 1) // 3 < z:
        n += 1
    return n


class MolecularHamiltonian:
    """Hamiltonian of a non-relativistic molecule.

    Args:
        mol: the molecule.
        ecp_type: if set ('bfd' or 'ccECP'), effective core potentials.
        ecp_mask: per-nucleus booleans selecting the ECP nuclei; by default
            those with Z > 2 when ``ecp_type`` is given.
        elec_std: scale of the initial electron clouds around the nuclei.
        laplacian_factory: ``f -> (r -> (lap f(r), grad f(r)))``; the forward
            Laplacian by default, ``physics.loop_laplacian`` as the oracle.
    """

    def __init__(self, *, mol: Molecule, ecp_type: Optional[str] = None, ecp_mask=None,
                 elec_std: float = 1.0, laplacian_factory=None):
        self.mol, self.elec_std, self.ecp_type = mol, elec_std, ecp_type
        self.laplacian = laplacian_factory or forward_laplacian
        charges = np.asarray(mol.charges)
        self.n_nuc = len(charges)
        if ecp_type is None:
            mask = np.zeros(self.n_nuc, bool)
        elif ecp_mask is None:
            mask = charges > 2  # He cores and lighter stay all-electron
        else:
            if len(ecp_mask) != self.n_nuc:
                raise ValueError('Incompatible shape of ecp_mask')
            mask = np.asarray(ecp_mask, bool)
        self.ecp_mask = mask
        self.ecp = GaussianTypeECP(charges, ecp_type, mask) if mask.any() else None
        self.ns_valence = charges if self.ecp is None else self.ecp.ns_valence
        self._nl_gens = {}  # device -> generator of the quadrature's rotations
        n_elec = int(self.ns_valence.sum()) - mol.charge
        if (n_elec + mol.spin) % 2:
            raise ValueError('n_elec and spin have different parity')
        if n_elec < 2:
            raise ValueError('The system must contain at least two active electrons.')
        self.n_up, self.n_down = ((n_elec + s * mol.spin) // 2 for s in (+1, -1))
        self.mol_shells = [get_shell(z) for z in charges]
        self.mol_ecp_shells = [get_shell(core + 1) - 1 for core in charges - self.ns_valence]

    # --- walker initialisation ------------------------------------------------

    def init_sample(
        self, gen: torch.Generator, n: int, R=None, elec_std: Optional[float] = None,
        dtype=torch.float64,
    ) -> PhysicalConfiguration:
        """Heuristic initial electron positions for ``n`` walkers around the
        nuclei ``R`` ``[n_nuc, 3]`` (None: the molecule's own geometry).

        The same heuristic as the JAX package (integer seats per nucleus,
        per-atom spin split with a nearest-neighbour bond walk, Gaussian
        clouds of width ``elec_std * sqrt(Z)``), vectorised over walkers and
        drawn from ``gen`` (on the generator's device).
        """
        dev = gen.device
        R = torch.as_tensor(self.mol.coords if R is None else R, dtype=dtype, device=dev)
        charges = torch.as_tensor(self.mol.charges, dtype=dtype, device=dev)
        seats = self._seat_electrons(gen, n, dev)
        up, down = self._distribute_spins(gen, R, seats)
        nuc_idx = torch.cat(
            [
                torch.searchsorted(
                    counts.cumsum(-1),
                    torch.arange(m, device=dev).expand(n, m).contiguous(),
                    right=True,
                )
                for counts, m in ((up, self.n_up), (down, self.n_down))
            ],
            dim=-1,
        )  # [n, n_elec]: electron i of a spin sits at the first nucleus whose
        # cumulative seat count exceeds i
        width = (elec_std or self.elec_std) * torch.sqrt(charges)[nuc_idx]
        noise = torch.randn(nuc_idx.shape + (3,), generator=gen, device=dev, dtype=dtype)
        r = R[nuc_idx] + width[..., None] * noise
        return PhysicalConfiguration(R, r, torch.zeros(n, dtype=torch.long, device=dev))

    def _seat_electrons(self, gen, n, dev):
        """Integer electron count per nucleus: the floor of the valence, then the
        remainder handed out one electron at a time toward the largest deficit."""
        valence = torch.as_tensor(
            self.ns_valence - self.mol.charge / self.n_nuc, dtype=torch.float64, device=dev
        )
        counts = torch.floor(valence).to(torch.long).expand(n, -1).clone()
        n_elec = self.n_up + self.n_down
        while (todo := counts.sum(-1) < n_elec).any():
            probs = torch.softmax(valence - counts, dim=-1)
            atom = torch.multinomial(probs, 1, generator=gen)[:, 0]
            counts[torch.arange(n, device=dev), atom] += todo.long()
        return counts

    def _distribute_spins(self, gen, R, seats):
        """Per-atom (up, down) seat counts: whole pairs level by level within
        the down-spin budget, then the leftovers placed one at a time with
        alternating spin along nearest-neighbour hops."""
        n, n_nuc = seats.shape
        dev = seats.device
        n_elec = self.n_up + self.n_down
        pairs = torch.zeros_like(seats)
        n_down_so_far = torch.zeros(n, dtype=torch.long, device=dev)
        for level in range(n_elec // 2 + 1):
            mask = seats >= 2 * (level + 1)
            fits = mask.sum(-1) + n_down_so_far <= self.n_down
            inc = (mask & fits[:, None]).long()
            pairs += inc
            n_down_so_far += inc.sum(-1)
        up, down = pairs.clone(), pairs.clone()

        dists = torch.cdist(R, R)
        dists.fill_diagonal_(float('inf'))
        neighbor_order = torch.argsort(dists, dim=-1, stable=True)  # [n_nuc, n_nuc]
        leftover = seats - up - down
        ties = leftover == leftover.amax(-1, keepdim=True)
        site = torch.multinomial(ties.double(), 1, generator=gen)[:, 0]
        rows = torch.arange(n, device=dev)
        for parity in (i % 2 for i in range(n_elec)):
            active = ((seats - up - down) > 0).any(-1)
            spin_down = bool(parity) & (down.sum(-1) < self.n_down) & active
            up[rows, site] += (active & ~spin_down).long()
            down[rows, site] += spin_down.long()
            by_proximity = neighbor_order[site]  # [n, n_nuc]
            still_open = (seats - up - down).gather(1, by_proximity) > 0
            nxt = by_proximity[rows, still_open.long().argmax(-1)]
            site = torch.where(active, nxt, site)
        return up, down

    # --- local energy ---------------------------------------------------------

    def local_energy(self, wf, phys_conf: PhysicalConfiguration, phi=None):
        """Per-walker local energy ``[B]`` and its terms.

        E_loc = -1/2 (lap log|psi| + |grad log|psi||^2) + V_loc + V_nl + V_el
        + E_nn, with the valence charges in V_loc and E_nn under an ECP.
        With an ECP the stats carry ``hamil/V_nl``, whose quadrature rotations
        are ``phi`` (see :meth:`.ecp.GaussianTypeECP.nonloc_potential`) or
        drawn from the Hamiltonian's own generator on the walkers' device,
        seeded with 0 (the JAX package draws them from the step's key).
        """
        R = phys_conf.R
        ns_valence = torch.as_tensor(self.ns_valence, dtype=R.dtype, device=R.device)

        def log_psi(r):
            return wf(phys_conf.replace(r=r)).log

        lap, grad = self.laplacian(log_psi)(phys_conf.r)
        force_sq = (grad * grad).sum(-1)
        terms = {'E_kin': -0.5 * (lap + force_sq)}
        if self.ecp is None:
            terms['V_loc'] = nuclear_potential(phys_conf.r, R, ns_valence)
        else:
            terms['V_loc'] = self.ecp.local_potential(phys_conf.r, R)
            phi = self.nl_rotations(phys_conf) if phi is None else phi
            terms['V_nl'] = self.ecp.nonloc_potential(phys_conf, wf, phi=phi)
        terms['V_el'] = electronic_potential(phys_conf.r)
        E_loc = sum(terms.values()) + nuclear_energy(R, ns_valence)
        stats = {f'hamil/{k}': v for k, v in terms.items()}
        stats |= {'hamil/lap': lap, 'hamil/quantum_force': force_sq}
        return E_loc, stats

    def nl_rotations(self, phys_conf) -> Optional[torch.Tensor]:
        """The nonlocal quadrature's rotations ``[n_nl_nuc, B, n]`` for the
        walkers of ``phys_conf``, drawn from the Hamiltonian's own generator on
        their device (None without a nonlocal ECP part)."""
        if self.ecp is None or not self.ecp.has_nonlocal:
            return None
        r = phys_conf.r
        return random_azimuths(self._nl_gen(r.device),
                               (len(self.ecp.nuc_with_nl_pot), *r.shape[:2]), r.dtype)

    def _nl_gen(self, device) -> torch.Generator:
        device = torch.device(device)
        if device not in self._nl_gens:
            self._nl_gens[device] = torch.Generator(device).manual_seed(0)
        return self._nl_gens[device]
