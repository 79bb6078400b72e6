"""Samplers over the electronic-state and molecule axes (counterpart of
``deepqmc_tpu/sampling/combined_samplers.py``).

The JAX package lifts an electron sampler over both axes with ``vmap``; here
each axis is a loop (the kernels are ``ctypes`` launches that ``torch.func.vmap``
cannot trace), so a sample call on one molecule makes one turn.  The state of
:class:`MultiNuclearGeometrySampler` is ``{'nuc', 'elec', 'update_nuc_counter'}``
with the molecule axis in front of every leaf: the electron leaves are
``[n_mol, n_state, B, ...]`` and ``tau`` ``[n_mol, n_state]``.  Each
electronic state has its own electron sampler, bound to that state's module
of a :class:`~..wf.StateStack`, and its own walkers.
"""

import torch

from .. import tracing
from ..types import PhysicalConfiguration
from ..utils import set_rows, tree_map, tree_stack

__all__ = [
    'IdleNucleiSampler', 'MoleculeIdxSampler', 'MultiElectronicStateSampler',
    'MultiNuclearGeometrySampler', 'no_elec_warp',
]


class IdleNucleiSampler:
    """The fixed-geometry nuclei "sampler": every move is zero."""

    def __init__(self, charges):
        del charges  # moving nuclei would need them; staying put does not

    def init(self, nuc_coords) -> dict:
        return {'R': nuc_coords}

    def sample(self, gen, state: dict):
        return state, torch.zeros_like(state['R']), {}


def no_elec_warp(gen, R, dR, elec_state: dict) -> dict:
    """The identity warp: electrons do not follow a nuclear move."""
    return elec_state


class MoleculeIdxSampler:
    """Batches of ``batch_size`` molecule indices (a CPU tensor) per
    :meth:`sample`, cycling through the molecules in order (``shuffle=False``),
    in one permutation drawn once (``'once'``) or in a new one per pass
    (``'always'``); permutations come from ``gen``, a CPU generator."""

    def __init__(self, gen: torch.Generator, n_mols: int, batch_size: int, shuffle=False):
        if shuffle not in (False, 'once', 'always'):
            raise ValueError(f"shuffle is False, 'once' or 'always', not {shuffle!r}")
        self.n_mols, self.batch_size = n_mols, batch_size
        self._gen, self._shuffle = gen, shuffle
        self._once = None
        self._queue: list[int] = []

    def _permutation(self) -> torch.Tensor:
        return torch.randperm(self.n_mols, generator=self._gen)

    def _next_epoch(self) -> list[int]:
        if not self._shuffle:
            return list(range(self.n_mols))
        if self._shuffle == 'always':
            return self._permutation().tolist()
        if self._once is None:
            self._once = self._permutation().tolist()
        return list(self._once)

    def sample(self) -> torch.Tensor:
        while len(self._queue) < self.batch_size:
            self._queue.extend(self._next_epoch())
        batch, self._queue = self._queue[:self.batch_size], self._queue[self.batch_size:]
        return torch.tensor(batch, dtype=torch.long)


class MultiElectronicStateSampler:
    """The electronic-state axis: one walker population per state, each
    initialised, moved and refreshed by its own electron sampler of
    ``samplers`` (one sampler for one state), in turn; every leaf and
    ``r`` and ``mol_idx`` of the configuration get the state axis in front."""

    def __init__(self, samplers, n_state: int):
        samplers = list(samplers) if isinstance(samplers, (list, tuple)) else [samplers]
        if len(samplers) != n_state:
            raise ValueError(f'{len(samplers)} electron samplers for {n_state} states')
        self.samplers, self.n_state = samplers, n_state
        self.sampler = samplers[0]  # the settings all states share

    def init(self, gen, n: int, R) -> dict:
        return tree_stack([s.init(gen, n, R) for s in self.samplers])

    def sample(self, gen, state: dict, R):
        outs = [s.sample(gen, _take(state, i), R) for i, s in enumerate(self.samplers)]
        pc = outs[0][1]
        phys_conf = pc.replace(r=torch.stack([o[1].r for o in outs]),
                               mol_idx=torch.stack([o[1].mol_idx for o in outs]))
        return tree_stack([o[0] for o in outs]), phys_conf, tree_stack([o[2] for o in outs])

    def update(self, state: dict, R) -> dict:
        return tree_stack([s.update(_take(state, i), R) for i, s in enumerate(self.samplers)])


def _take(tree, i: int):
    return tree_map(lambda x: x[i], tree)


class MultiNuclearGeometrySampler:
    """The molecule axis, with optional nuclear moves.

    :meth:`sample` moves the walkers of the molecules ``mol_idxs`` (a CPU
    tensor) and writes them back into a copy of each leaf, so the other
    molecules keep theirs bit for bit; the configuration it returns has ``R``
    ``[m, n_nuc, 3]`` (one geometry per molecule of the batch), ``r``
    ``[m, n_state, B, n, 3]`` and ``mol_idx`` ``[m, n_state, B]`` stamped with
    each walker's molecule index.  With ``update_nuc_period``, each molecule's
    nuclei move on every period-th visit; the electrons are then warped, their
    psi refreshed and ``elec_equilibration_steps`` moves made.  The visit
    counter lives on the CPU, so the decision costs no device sync.
    """

    def __init__(self, elec_sampler: MultiElectronicStateSampler, nuc_sampler, warp_elec_fn,
                 update_nuc_period, elec_equilibration_steps):
        self.elec = elec_sampler
        self.nuc_sampler = nuc_sampler
        self.warp_elec_fn = warp_elec_fn
        self.update_nuc_period = update_nuc_period
        self.elec_equilibration_steps = elec_equilibration_steps
        # electron moves a molecule per sample call (a nuclear move's adds none)
        self.moves = getattr(elec_sampler.sampler, 'length', 1) * elec_sampler.n_state

    def init(self, gen, n: int, R) -> dict:
        """Walkers for each geometry of ``R`` ``[n_mol, n_nuc, 3]``."""
        return {
            'nuc': tree_stack([self.nuc_sampler.init(R_i) for R_i in R]),
            'elec': tree_stack([self.elec.init(gen, n, R_i) for R_i in R]),
            'update_nuc_counter': torch.zeros(len(R), dtype=torch.long),
        }

    def _advance_nuclei(self, gen, part: dict) -> dict:
        nuc, dR, _ = self.nuc_sampler.sample(gen, part['nuc'])
        elec = self.warp_elec_fn(gen, nuc['R'], dR, part['elec'])
        elec = self.elec.update(elec, nuc['R'])
        for _ in range(self.elec_equilibration_steps or 0):
            elec = self.elec.sample(gen, elec, nuc['R'])[0]
        return {**part, 'nuc': nuc, 'elec': elec}

    def sample(self, gen, state: dict, mol_idxs: torch.Tensor):
        with tracing.span('sampling.sample', moves=self.moves * len(mol_idxs)):
            state = dict(state)
            counter = state.pop('update_nuc_counter')
            idxs = mol_idxs.tolist()
            parts = [_take(state, i) for i in idxs]
            if self.update_nuc_period is not None:
                due = counter[mol_idxs] == self.update_nuc_period - 1
                parts = [self._advance_nuclei(gen, p) if d else p
                         for p, d in zip(parts, due.tolist())]
                counter = counter.index_copy(0, mol_idxs,
                                             torch.where(due, 0, counter[mol_idxs] + 1))
            outs = [self.elec.sample(gen, p['elec'], p['nuc']['R']) for p in parts]
            parts = [{**p, 'elec': elec} for p, (elec, _, _) in zip(parts, outs)]
            state = tree_map(lambda full, *part: set_rows(full, idxs, part), state, *parts)
            state['update_nuc_counter'] = counter
            phys_conf = PhysicalConfiguration(
                torch.stack([p['nuc']['R'] for p in parts]),
                torch.stack([pc.r for _, pc, _ in outs]),
                torch.stack([torch.full_like(pc.mol_idx, i) for i, (_, pc, _) in zip(idxs, outs)]),
            )
            return state, phys_conf, tree_stack([stats for _, _, stats in outs])

    def update(self, state: dict) -> dict:
        """Refresh psi (and what the electron sampler keeps with it) for every molecule."""
        with tracing.span('sampling.update'):
            R = state['nuc']['R']
            elec = [self.elec.update(_take(state['elec'], i), R[i]) for i in range(len(R))]
            return {**state, 'elec': tree_stack(elec)}
