"""The step of ``deepqmc_tpu/fit.py`` (``step_body``) for one electronic state
and one molecule per step, with the :func:`evaluate` and :func:`train` loops
around it and their equilibration phase (``deepqmc_tpu/train.py:243-272``).

Sampling goes through the combined sampler (``sampling/combined_samplers.py``)
over the geometries ``mols``; each step draws a molecule index, moves that
molecule's walkers with the electron sampler (a recipe of
``sampling/recipes.py``, or ``bench.py``'s Metropolis at ``decorr`` moves by
default) and updates the EWM grid ``[n_mol, 1]`` at that index.

An evaluation step: the moves, the local energy of the new walkers via the
forward Laplacian, the ``local_energy/*`` statistics and the EWM estimators of
the energy and its spread.  Evaluation leaves the parameters alone, so the
sampler's psi cache needs no refresh.

A training step: the same moves; the walkers' weights, normalised to unit mean
from the sampler's ``log_weight`` where it keeps one (``ResampledSampler``), or
one; the optimizer's step (the local energy, the clipped VMC gradient by one
backward pass of log|psi|, and the KFAC or Adam update of the parameters) on
the molecule's walkers and geometry; then the psi refresh of every molecule's
walkers through the outermost sampler's ``update`` (which also moves the
weights); and the same statistics, shaped ``[1, 1]`` (molecule, state) as the
JAX package's.
"""

from collections.abc import Iterator
from typing import NamedTuple

import numpy as np
import torch

from .ewm import init_multi_mol_multi_state_ewm
from .loss import create_loss_fn, median_log_squeeze_and_mask
from .optimizer import AdamOptimizer, KFACOptimizer, NoOptimizer
from .parallel import pexp_normalize_mean
from .physics import pairwise_self_distance
from .sampling import (
    RECIPES,
    DecorrSampler,
    MetropolisSampler,
    equilibrate,
    initialize_sampler_state,
    initialize_sampling,
)
from .types import PhysicalConfiguration
from .utils import ConstantSchedule, InverseSchedule, resolve_device, set_true_fp32, tree_map

__all__ = [
    'TrainState', 'eval_step', 'evaluate', 'molecule_conf', 'molecule_state', 'train',
    'train_step',
]

OPTIMIZERS = {'kfac': KFACOptimizer, 'adam': AdamOptimizer, 'none': NoOptimizer}
# the JAX package's bench.py settings: KFAC as bench.py:130-139, Adam at 1e-3
DEFAULT_OPT_KWARGS = {
    'kfac': dict(learning_rate_schedule=InverseSchedule(0.05, 10000),
                 damping_schedule=ConstantSchedule(1e-3), norm_constraint=1e-3),
    'adam': dict(lr=1e-3),
    'none': {},
}
EQ_BLOCK_SIZE = 10  # the equilibration's early-stopping blocks (train.py:257)


class TrainState(NamedTuple):
    """The sampler's state and the optimizer's; the parameters live in the wave function."""

    sampler: dict
    opt: object


def molecule_conf(phys_conf: PhysicalConfiguration) -> PhysicalConfiguration:
    """The walkers of a one-molecule batch of the combined sampler, state 0:
    ``R`` ``[n_nuc, 3]``, ``r`` ``[B, n, 3]``, ``mol_idx`` ``[B]``."""
    if phys_conf.r.shape[0] != 1:
        raise NotImplementedError(
            f'a step on {phys_conf.r.shape[0]} molecules: the step takes one molecule '
            '(molecule_batch_size=1; ROADMAP.md, queue 1 item 2)'
        )
    return PhysicalConfiguration(phys_conf.R[0], phys_conf.r[0, 0], phys_conf.mol_idx[0, 0])


def molecule_state(smpl_state: dict, i: int = 0):
    """(``R`` ``[n_nuc, 3]``, the electron sampler's state) of molecule ``i`` of
    a combined sampler state, state 0."""
    return smpl_state['nuc']['R'][i], tree_map(lambda x: x[i, 0], smpl_state['elec'])


def _rows(t, idxs):
    return torch.stack([t[i] for i in idxs])


def walker_weights(smpl_state: dict, mol_idxs) -> torch.Tensor:
    """The weights ``[m, 1, B]`` of the walkers of the molecules ``mol_idxs``:
    ``exp(log_weight)`` normalised to unit mean where the sampler keeps
    ``log_weight``, else one (``deepqmc_tpu/fit.py:102-106``)."""
    elec, idxs = smpl_state['elec'], mol_idxs.tolist()
    if 'log_weight' in elec:
        return pexp_normalize_mean(_rows(elec['log_weight'], idxs), dim=-1)
    r = elec['r']
    return torch.ones(len(idxs), *r.shape[1:3], dtype=r.dtype, device=r.device)


def eval_step(gen, hamil, wf, sampler, state, mol_idxs, ewm, std_ewm, update_ewm):
    """One evaluation step; returns (state, ewm, std_ewm, E_loc [B], stats)."""
    state, phys_conf, smpl_stats = sampler.sample(gen, state, mol_idxs)
    E_loc, hamil_stats = hamil.local_energy(wf, molecule_conf(phys_conf))
    stats = {**{k: v.mean() for k, v in hamil_stats.items()}, **smpl_stats}
    ewm, std_ewm, stats = _energy_stats(E_loc, stats, mol_idxs, ewm, std_ewm, update_ewm)
    return state, ewm, std_ewm, E_loc, stats


def _energy_stats(E_loc, stats, mol_idxs, ewm, std_ewm, update_ewm):
    """The ``local_energy/*`` statistics and the EWMs of the energy and its
    spread, each ``[1, 1]`` (molecule, state), the EWMs updated at ``mol_idxs``."""
    E = E_loc[None, None]
    stats = {
        **stats,
        'local_energy/mean': E.mean(-1),
        'local_energy/std': E.std(-1, correction=0),
        'local_energy/min': E.amin(-1),
        'local_energy/max': E.amax(-1),
    }
    ewm = update_ewm(stats['local_energy/mean'], ewm, mol_idxs)
    std_ewm = update_ewm(stats['local_energy/std'], std_ewm, mol_idxs)
    idxs = mol_idxs.tolist()
    stats |= {
        'energy/ewm': _rows(ewm.mean, idxs),
        'energy/ewm_error': torch.sqrt(_rows(ewm.sqerr, idxs)),
        'energy/std_ewm': _rows(std_ewm.mean, idxs),
    }
    return ewm, std_ewm, stats


def train_step(gen, sampler, opt, train_state: TrainState, mol_idxs, ewm, std_ewm, update_ewm):
    """One training step; returns (train_state, ewm, std_ewm, E_loc [B], stats)."""
    with torch.no_grad():
        smpl_state, phys_conf, smpl_stats = sampler.sample(gen, train_state.sampler, mol_idxs)
    weight = walker_weights(smpl_state, mol_idxs)[0, 0]
    opt_state, E_loc, stats = opt.step(train_state.opt, molecule_conf(phys_conf), weight)
    if not isinstance(opt, NoOptimizer):
        with torch.no_grad():  # the parameters changed: refresh the cached psi
            smpl_state = sampler.update(smpl_state)
    ewm, std_ewm, stats = _energy_stats(
        E_loc, {**stats, **smpl_stats}, mol_idxs, ewm, std_ewm, update_ewm
    )
    return TrainState(smpl_state, opt_state), ewm, std_ewm, E_loc, stats


def _electron_sampler(sampler, decorr: int):
    """A factory ``(hamil, wf) -> electron sampler``: a recipe by name, the
    factory given, or for None bench.py's Metropolis at ``decorr`` moves."""
    if sampler is None:
        return lambda hamil, wf: DecorrSampler(length=decorr).wrap(MetropolisSampler(hamil, wf))
    if isinstance(sampler, str):
        if sampler not in RECIPES:
            raise ValueError(f'unknown sampler recipe {sampler!r} (the port has {sorted(RECIPES)})')
        return RECIPES[sampler]
    return sampler


def _sampling(hamil, wf, *, sampler, decorr, mols, molecule_batch_size, n_walkers, seed,
              device, inference: bool):
    """(molecule-index sampler, combined sampler, its state, the moves'
    generator, the grad mode of sampling) on ``device``; the grad mode is
    inference mode where ``inference`` asks for it and the sampler allows it."""
    mols = [hamil.mol] if mols is None else list(mols)
    ref = hamil.mol
    for mol in mols:
        if not (np.array_equal(mol.charges, ref.charges) and mol.charge == ref.charge
                and mol.spin == ref.spin):
            raise ValueError('every molecule of mols must have the charges, charge and spin '
                             'of hamil.mol')
    idx_sampler, smpl = initialize_sampling(
        torch.Generator().manual_seed(seed + 2), hamil, wf, mols, 1, molecule_batch_size,
        elec_sampler=_electron_sampler(sampler, decorr),
    )
    # a force sampler needs autograd, which inference mode forbids
    uses_autograd = getattr(smpl.elec.sampler, 'uses_autograd', False)
    grad_mode = torch.inference_mode if inference and not uses_autograd else torch.no_grad
    with grad_mode():
        state = initialize_sampler_state(torch.Generator().manual_seed(seed), smpl, n_walkers,
                                         mols, dtype=torch.float32, device=device)
    return idx_sampler, smpl, state, torch.Generator(device).manual_seed(seed + 1), grad_mode


def _equilibration(gen, idx_sampler, sampler, state, grad_mode, max_eq_steps,
                   allow_early_stopping):
    """Yields ``(step, state, stats)`` of up to ``max_eq_steps`` sample calls,
    each under ``grad_mode``, with early stopping on the mean electron distance
    and the spread of log|psi| (``train.py:243-272``)."""
    steps = equilibrate(
        gen, idx_sampler, sampler, state, lambda pc: pairwise_self_distance(pc.r).mean(),
        range(max_eq_steps), block_size=EQ_BLOCK_SIZE, allow_early_stopping=allow_early_stopping,
    )
    while True:
        with grad_mode():  # left before each yield, so the caller's mode is its own
            item = next(steps, None)
        if item is None:
            return
        step, state, _, stats = item
        yield step, state, stats


def evaluate(
    hamil, wf, *, n_walkers: int = 2048, steps: int = 3, decorr: int = 10, seed: int = 0,
    device=None, sampler=None, mols=None, max_eq_steps: int = 0,
    eq_allow_early_stopping: bool = True,
) -> Iterator[tuple[int, dict, torch.Tensor, dict]]:
    """Evaluate ``wf`` on ``hamil``: yields ``(step, sampler_state, E_loc, stats)``.

    ``sampler`` is a recipe name of ``sampling.RECIPES``, a factory ``(hamil,
    wf) -> electron sampler``, or None for bench.py's Metropolis at ``decorr``
    moves a step.  ``mols`` are geometries of ``hamil.mol`` (same charges,
    charge and spin; default ``[hamil.mol]``), one per step in a shuffled
    cycle.  With ``max_eq_steps`` > 0 the walkers are first equilibrated: those
    sample calls are yielded first, each as ``(step, sampler_state, None,
    sampler_stats)``.  Runs on ``device`` (``None`` means CUDA, and raises where
    it is absent) in float32, with TF32 off.  Walkers start from
    ``hamil.init_sample`` drawn on the CPU from ``seed``; the moves draw from a
    generator on the device seeded with ``seed + 1``.  Each step runs under
    ``torch.inference_mode()``, or ``torch.no_grad()`` for a sampler whose
    force needs autograd (Langevin).
    """
    device = resolve_device(device)
    if device.type == 'cuda':
        set_true_fp32()
    wf = wf.to(device=device, dtype=torch.float32)
    idx_sampler, sampler, state, gen, grad_mode = _sampling(
        hamil, wf, sampler=sampler, decorr=decorr, mols=mols, molecule_batch_size=1,
        n_walkers=n_walkers, seed=seed, device=device, inference=True,
    )
    for step, state, stats in _equilibration(gen, idx_sampler, sampler, state, grad_mode,
                                             max_eq_steps, eq_allow_early_stopping):
        yield step, state, None, stats
    ewm, update_ewm = init_multi_mol_multi_state_ewm((idx_sampler.n_mols, 1), device=device)
    std_ewm = ewm
    for step in range(steps):
        with grad_mode():
            state, ewm, std_ewm, E_loc, stats = eval_step(
                gen, hamil, wf, sampler, state, idx_sampler.sample(), ewm, std_ewm, update_ewm
            )
        yield step, state, E_loc, stats


def train(
    hamil, wf, *, n_walkers: int = 2048, steps: int = 10, decorr: int = 10, seed: int = 0,
    optimizer: str = 'kfac', device=None, sampler=None, mols=None, molecule_batch_size: int = 1,
    max_eq_steps: int = 0, eq_allow_early_stopping: bool = True,
    clip_mask_fn=median_log_squeeze_and_mask, **opt_kwargs,
) -> Iterator[tuple[int, TrainState, torch.Tensor, dict]]:
    """Train ``wf`` on ``hamil``: yields ``(step, train_state, E_loc, stats)``.

    ``optimizer`` is 'kfac' (default settings as the JAX package's bench.py:
    lr 0.05 / (1 + n / 10000), damping 1e-3, norm constraint 1e-3, inverses
    every 5 steps), 'adam' (lr 1e-3) or 'none'; ``opt_kwargs`` override them.
    The local energies are clipped by ``clip_mask_fn`` (for the PsiFormer's
    recipe, ``partial(median_clip_and_mask, clip_width=5, median_center=True)``).
    ``sampler``, ``mols``, ``max_eq_steps`` and ``eq_allow_early_stopping`` are
    as :func:`evaluate`'s; the equilibration's calls come first, each as
    ``(step, TrainState(sampler_state, None), None, sampler_stats)``.  A step
    takes one molecule (``molecule_batch_size`` 1).  Runs on ``device``
    (``None`` means CUDA, and raises where it is absent) in float32 with TF32
    off; ``wf`` is moved there and its parameters are updated in place.
    Walkers start from ``hamil.init_sample`` drawn on the CPU from ``seed``; the
    moves draw from a generator on the device seeded with ``seed + 1``.
    """
    if molecule_batch_size != 1:
        raise NotImplementedError(
            f'molecule_batch_size={molecule_batch_size}: the training step takes one '
            'molecule (ROADMAP.md, queue 1 item 2)'
        )
    device = resolve_device(device)
    if device.type == 'cuda':
        set_true_fp32()
    wf = wf.to(device=device, dtype=torch.float32)
    idx_sampler, sampler, smpl_state, gen, grad_mode = _sampling(
        hamil, wf, sampler=sampler, decorr=decorr, mols=mols,
        molecule_batch_size=molecule_batch_size, n_walkers=n_walkers, seed=seed, device=device,
        inference=False,
    )
    for step, smpl_state, stats in _equilibration(gen, idx_sampler, sampler, smpl_state,
                                                  grad_mode, max_eq_steps,
                                                  eq_allow_early_stopping):
        yield step, TrainState(smpl_state, None), None, stats
    loss = create_loss_fn(hamil, wf, clip_mask_fn)
    opt = OPTIMIZERS[optimizer](loss, **(DEFAULT_OPT_KWARGS[optimizer] | opt_kwargs))
    ewm, update_ewm = init_multi_mol_multi_state_ewm((idx_sampler.n_mols, 1), device=device)
    std_ewm = ewm
    R, elec = molecule_state(smpl_state)
    train_state = TrainState(smpl_state, opt.init(MetropolisSampler.phys_conf(R, elec['r'])))
    for step in range(steps):
        train_state, ewm, std_ewm, E_loc, stats = train_step(
            gen, sampler, opt, train_state, idx_sampler.sample(), ewm, std_ewm, update_ewm
        )
        yield step, train_state, E_loc, stats
