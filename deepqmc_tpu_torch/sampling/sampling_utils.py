"""Sampler composition, the regularised Langevin force, equilibration and
the set-up of the combined samplers (counterpart of
``deepqmc_tpu/sampling/sampling_utils.py``); the sampler state is sharded
over the ranks on its walker axis (:func:`..parallel.shard_walkers`)."""

from collections.abc import Callable, Iterable
from functools import reduce
from statistics import mean, stdev

import numpy as np
import torch

from ..physics import pairwise_diffs
from ..utils import sampling_precision_ctx
from ..wf.base import wf_states
from .combined_samplers import (
    IdleNucleiSampler,
    MoleculeIdxSampler,
    MultiElectronicStateSampler,
    MultiNuclearGeometrySampler,
    no_elec_warp,
)

__all__ = [
    'chain', 'clean_force', 'combine_samplers', 'crossover_parameter', 'diffs_to_nearest_nuc',
    'equilibrate', 'initialize_sampler_state', 'initialize_sampling',
]


def chain(*samplers):
    """Wrap a base electron sampler (last) in wrappers (first is outermost):
    ``chain(DecorrSampler(length=20), metropolis)`` keeps every 20th move."""
    *wrappers, base = samplers
    return reduce(lambda inner, w: w.wrap(inner), reversed(wrappers), base)


def combine_samplers(samplers, hamil, wf):
    """The base sampler factory (last) made with ``hamil`` and ``wf``, then chained."""
    return chain(*samplers[:-1], samplers[-1](hamil=hamil, wf=wf))


def _unit(v, eps=None):
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / (norm if eps is None else norm.clamp(min=eps))


def diffs_to_nearest_nuc(r, coords):
    """The displacement from each electron ``r`` ``[..., n, 3]`` to its nearest
    nucleus of ``coords`` ``[n_nuc, 3]``, with its squared length as a fourth
    channel ``[..., n, 4]``, and that nucleus' index ``[..., n]``."""
    disp = pairwise_diffs(r, coords)
    nearest = disp[..., -1].argmin(-1)
    index = nearest[..., None, None].expand(*nearest.shape, 1, disp.shape[-1])
    return disp.gather(-2, index).squeeze(-2), nearest


def crossover_parameter(disp, force, charge):
    """Umrigar's crossover a(r): near 1 along the force far from a nucleus,
    falling toward the nucleus."""
    toward_nuc, dist2 = disp[..., :3], disp[..., 3]
    eps = torch.finfo(force.dtype).eps
    alignment = (_unit(force, eps) * _unit(toward_nuc)).sum(-1)
    zeta = charge**2 * dist2
    return (1 + alignment) / 2 + zeta / (10 * (4 + zeta))


def clean_force(force, phys_conf, mol, *, tau):
    """The quantum force ``[B, n, 3]`` regularised for a Langevin proposal of
    step ``tau``: large forces damped by the crossover, then capped so that a
    drift step does not overshoot the nearest nucleus."""
    r = phys_conf.r
    disp, nearest = diffs_to_nearest_nuc(r, phys_conf.R)
    charges = torch.as_tensor(mol.charges, dtype=r.dtype, device=r.device)
    a = crossover_parameter(disp, force, charges[nearest])
    av2tau = a * (force**2).sum(-1) * tau
    damped = (2 / (torch.sqrt(1 + 2 * av2tau) + 1))[..., None] * force
    eps = torch.finfo(r.dtype).eps
    drift_len = tau * torch.linalg.vector_norm(damped, dim=-1).clamp(min=eps)
    cap = torch.clamp(torch.sqrt(disp[..., -1]) / drift_len, max=1.0)
    return damped * cap[..., None]


def equilibrate(
    gen: torch.Generator,
    molecule_idx_sampler: MoleculeIdxSampler,
    sampler: MultiNuclearGeometrySampler,
    state: dict,
    criterion: Callable,
    steps: Iterable[int],
    *,
    block_size: int,
    n_blocks: int = 5,
    allow_early_stopping: bool = True,
):
    """Move the walkers until the criterion's series settles; yields
    ``(step, state, mol_idxs, stats)`` after each sample call.

    With early stopping, the run ends once a full window of ``block_size *
    n_blocks`` calls of ``criterion(phys_conf)`` has its oldest and newest
    block agree to within either block's own scatter, and, where the sampler
    reports ``sampling/log_psi/std``, a full window of that spread does too.
    Each call runs under ``torch.no_grad()``; reading the criterion waits for
    the device, as the JAX package's does.
    """

    def stabilized(series: list[float]) -> bool:
        head, tail = series[:block_size], series[-block_size:]
        return abs(mean(head) - mean(tail)) < min(stdev(head), stdev(tail))

    window = block_size * n_blocks
    series: list[float] = []
    psi_series: list[float] = []
    for step in steps:
        mol_idxs = molecule_idx_sampler.sample()
        with torch.no_grad(), sampling_precision_ctx():
            state, phys_conf, stats = sampler.sample(gen, state, mol_idxs)
        yield step, state, mol_idxs, stats
        if allow_early_stopping:
            series = [*series[-window + 1:], float(criterion(phys_conf))]
            spread = stats.get('sampling/log_psi/std')
            if spread is not None:
                psi_series = [*psi_series[-window + 1:],
                              float(torch.as_tensor(spread, dtype=torch.float64).mean())]
            if (
                len(series) == window
                and stabilized(series)
                and (not psi_series or (len(psi_series) == window and stabilized(psi_series)))
            ):
                break


def initialize_sampling(
    gen: torch.Generator,
    hamil,
    wf,
    mols,
    electronic_states: int,
    molecule_batch_size: int,
    *,
    elec_sampler,
    nuc_sampler=None,
    elec_warp_fn=None,
    update_nuc_period=None,
    elec_equilibration_steps=None,
):
    """The molecule-index sampler (``gen``, a CPU generator, draws its one
    shuffle) and the combined sampler around ``elec_sampler(hamil=, wf=)``,
    one per state module of ``wf`` (a module, or a :class:`~..wf.StateStack`
    of ``electronic_states``)."""
    molecule_idx_sampler = MoleculeIdxSampler(gen, len(mols), molecule_batch_size, 'once')
    multi_state = MultiElectronicStateSampler(
        [elec_sampler(hamil=hamil, wf=w) for w in wf_states(wf)], electronic_states)
    nuc_sampler = (nuc_sampler or IdleNucleiSampler)(hamil.mol.charges)
    sampler = MultiNuclearGeometrySampler(
        multi_state, nuc_sampler, elec_warp_fn or no_elec_warp, update_nuc_period,
        elec_equilibration_steps,
    )
    return molecule_idx_sampler, sampler


def initialize_sampler_state(gen: torch.Generator, sampler, n: int, mols, *,
                             dtype=torch.float64, device=None) -> dict:
    """The combined state of ``n`` walkers per geometry of ``mols``, with the
    nuclei in ``dtype`` on ``device``; walkers drawn with ``gen``, of which
    each rank keeps its share before it evaluates them (``[mol, state,
    walker, ...]``, JAX ``sampling_utils.py:184-199``; the electron sampler's
    ``init`` shards): the walkers of one process are those of the same draw
    on several."""
    R = torch.as_tensor(np.stack([m.coords for m in mols]), dtype=dtype, device=device)
    return sampler.init(gen, n, R)
