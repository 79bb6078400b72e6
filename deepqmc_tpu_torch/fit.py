"""The step of ``deepqmc_tpu/fit.py`` (``step_body``) for one or more
molecules per step, with the :func:`evaluate` and :func:`train` loops of one
electronic state around it and their equilibration phase
(``deepqmc_tpu/train.py:243-272``); :func:`fit_wf` runs it over one or more
states (a :class:`~.wf.StateStack`).

Sampling goes through the combined sampler (``sampling/combined_samplers.py``)
over the geometries ``mols``; each step draws ``molecule_batch_size``
molecule indices (the same on every rank), moves those molecules' walkers
with the electron sampler (a recipe of ``sampling/recipes.py``, or
``bench.py``'s Metropolis at ``decorr`` moves by default) and updates the EWM
grid ``[n_mol, S]`` at those indices.  With walkers sharded over processes
(:mod:`.parallel`) each rank moves its shard and every statistic is over the
global walker axis.

An evaluation step: the moves, the local energy of the new walkers via the
forward Laplacian, the ``local_energy/*`` statistics and the EWM estimators of
the energy and its spread.  Evaluation leaves the parameters alone, so the
sampler's psi cache needs no refresh.

A training step: the same moves; the walkers' weights, normalised to unit mean
from the sampler's ``log_weight`` where it keeps one (``ResampledSampler``), or
one; the optimizer's step (the local energy, the clipped VMC gradient by one
backward pass of log|psi|, and the KFAC or Adam update of the parameters) on
the molecule's walkers and geometry, with the EWMs of the molecule's energy
and spread (``data``, which the overlap penalty of several states reads); then
the psi refresh of every molecule's walkers through the outermost sampler's
``update`` (which also moves the weights); and the same statistics, shaped
``[m, S]`` (molecule, state) as the JAX package's.
"""

import contextlib
import itertools
import time
from collections.abc import Generator, Iterable, Iterator
from typing import NamedTuple

import numpy as np
import torch

from . import tracing
from .ewm import init_multi_mol_multi_state_ewm
from .loss import create_loss_fn, median_log_squeeze_and_mask
from .loss.energy import compute_local_energy
from .optimizer import AdamOptimizer, KFACOptimizer, NoOptimizer
from .parallel import (
    all_device_max,
    all_device_mean,
    all_device_min,
    all_device_std,
    get_process_count,
    get_process_index,
    pexp_normalize_mean,
    replicate_on_devices,
)
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
from .utils import (
    ConstantSchedule,
    InverseSchedule,
    resolve_device,
    sampling_precision_ctx,
    set_true_fp32,
    split_dict,
    tree_map,
)

__all__ = [
    'TrainState', 'eval_step', 'evaluate', 'fit_wf', 'molecule_state', 'train', 'train_step',
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
    """The sampler's state, the parameters and the optimizer's state
    (``deepqmc_tpu/types.py:69-74``).  ``params`` is the wave function's
    ``state_dict``: its tensors share the module's storage, so they follow its
    in-place updates, and a restart loads them into the module."""

    sampler: dict
    params: object
    opt: object


def molecule_state(smpl_state: dict, i: int = 0):
    """(``R`` ``[n_nuc, 3]``, the electron sampler's state) of molecule ``i`` of
    a combined sampler state, state 0."""
    return smpl_state['nuc']['R'][i], tree_map(lambda x: x[i, 0], smpl_state['elec'])


def _rows(t, idxs):
    return torch.stack([t[i] for i in idxs])


def walker_weights(smpl_state: dict, mol_idxs) -> torch.Tensor:
    """The weights ``[m, S, B]`` of the walkers of the molecules ``mol_idxs``:
    ``exp(log_weight)`` normalised to unit mean over the global walker axis
    where the sampler keeps ``log_weight``, else one (``deepqmc_tpu/fit.py:102-106``)."""
    elec, idxs = smpl_state['elec'], mol_idxs.tolist()
    if 'log_weight' in elec:
        return pexp_normalize_mean(_rows(elec['log_weight'], idxs), dim=-1)
    r = elec['r']
    return torch.ones(len(idxs), *r.shape[1:3], dtype=r.dtype, device=r.device)


def eval_step(gen, hamil, wf, sampler, state, mol_idxs, ewm, std_ewm, update_ewm,
              eloc_walker_chunk=None):
    """One evaluation step; returns (state, ewm, std_ewm, E_loc ``[m, 1, B]``,
    stats), the molecules' walkers in one pass of the local energy (``R`` per
    walker).  ``eloc_walker_chunk`` as in :func:`.loss.compute_local_energy`."""
    with sampling_precision_ctx():
        state, phys_conf, smpl_stats = sampler.sample(gen, state, mol_idxs)
    m = len(mol_idxs)
    E_loc, hamil_stats = compute_local_energy(hamil, wf, phys_conf.state(0),
                                              walker_chunk=eloc_walker_chunk)
    E_loc = E_loc.view(m, 1, -1)
    stats = {**{k: all_device_mean(v.view(m, 1, -1), -1) for k, v in hamil_stats.items()},
             **smpl_stats}
    ewm, std_ewm, stats = _energy_stats(E_loc, stats, mol_idxs, ewm, std_ewm, update_ewm)
    return state, ewm, std_ewm, E_loc, stats


def _energy_stats(E_loc, stats, mol_idxs, ewm, std_ewm, update_ewm):
    """The ``local_energy/*`` statistics over the global walker axis and the
    EWMs of the energy and its spread, each ``[m, S]`` (molecule, state), the
    EWMs updated at ``mol_idxs``."""
    with tracing.span('fit.stats'):
        E = E_loc.view(len(mol_idxs), -1, E_loc.shape[-1])
        stats = {
            **stats,
            'local_energy/mean': all_device_mean(E, -1),
            'local_energy/std': all_device_std(E, -1),
            'local_energy/min': all_device_min(E, -1),
            'local_energy/max': all_device_max(E, -1),
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
    """One training step on the sampler's ``[m, S, B]`` grid; returns
    (train_state, ewm, std_ewm, E_loc ``[m, S, B]``, psi_ratio ``[m, S, S, B]``
    (None for one state), stats)."""
    with torch.no_grad(), sampling_precision_ctx():
        smpl_state, phys_conf, smpl_stats = sampler.sample(gen, train_state.sampler, mol_idxs)
    idxs = mol_idxs.tolist()
    data = {'energy_ewm': _rows(ewm.mean, idxs), 'std_ewm': _rows(std_ewm.mean, idxs)}
    opt_state, E_loc, psi_ratio, stats = opt.step(train_state.opt, phys_conf,
                                                  walker_weights(smpl_state, mol_idxs), data)
    if not isinstance(opt, NoOptimizer):
        # the parameters changed: refresh the cached psi, at the sampling
        # precision so the acceptance ratios stay unbiased
        with torch.no_grad(), sampling_precision_ctx():
            smpl_state = sampler.update(smpl_state)
    ewm, std_ewm, stats = _energy_stats(
        E_loc, {**stats, **smpl_stats}, mol_idxs, ewm, std_ewm, update_ewm
    )
    return (TrainState(smpl_state, train_state.params, opt_state), ewm, std_ewm, E_loc,
            psi_ratio, stats)


def electron_sampler(sampler, decorr: int):
    """A factory ``(hamil, wf) -> electron sampler``: a recipe by name, the
    factory given, or for None bench.py's Metropolis at ``decorr`` moves."""
    if sampler is None:
        return lambda hamil, wf: DecorrSampler(length=decorr).wrap(MetropolisSampler(hamil, wf))
    if isinstance(sampler, str):
        if sampler not in RECIPES:
            raise ValueError(f'unknown sampler recipe {sampler!r} (the port has {sorted(RECIPES)})')
        return RECIPES[sampler]
    return sampler


def electron_grad_mode(elec_sampler, inference: bool):
    """The grad mode to sample in with the electron sampler ``elec_sampler``
    (wrappers included): inference mode where ``inference`` asks for it,
    unless the sampler's force needs autograd, which inference mode forbids;
    else ``no_grad``."""
    uses_autograd = getattr(elec_sampler, 'uses_autograd', False)
    return torch.inference_mode if inference and not uses_autograd else torch.no_grad


def sampling_grad_mode(sampler, inference: bool):
    """:func:`electron_grad_mode` of the combined ``sampler``'s electron sampler."""
    return electron_grad_mode(sampler.elec.sampler, inference)


def _sampling(hamil, wf, *, sampler, decorr, mols, molecule_batch_size, n_walkers, seed,
              device, inference: bool):
    """(molecule-index sampler, combined sampler, its state, the moves'
    generator, the grad mode of sampling) on ``device``; the grad mode is
    inference mode where ``inference`` asks for it and the sampler allows it.
    The ``n_walkers`` of each molecule are drawn whole from ``seed`` and
    sharded over the ranks; the molecule indices come from ``seed`` on every
    rank, the moves from ``seed + 1`` plus the rank (JAX ``train.py:137``
    seeds each process with ``seed`` plus its index)."""
    mols = [hamil.mol] if mols is None else list(mols)
    if not 1 <= molecule_batch_size <= len(mols):
        raise ValueError(f'Molecule batch size ({molecule_batch_size}) is larger than the number '
                         f'of molecules in the dataset ({len(mols)})!')
    if n_walkers % get_process_count():
        raise ValueError(f'Electron batch size ({n_walkers}) cannot be evenly split across '
                         f'{get_process_count()} processes!')
    ref = hamil.mol
    for mol in mols:
        if not (np.array_equal(mol.charges, ref.charges) and mol.charge == ref.charge
                and mol.spin == ref.spin):
            raise ValueError('every molecule of mols must have the charges, charge and spin '
                             'of hamil.mol')
    idx_sampler, smpl = initialize_sampling(
        torch.Generator().manual_seed(seed + 2), hamil, wf, mols, 1, molecule_batch_size,
        elec_sampler=electron_sampler(sampler, decorr),
    )
    grad_mode = sampling_grad_mode(smpl, inference)
    with grad_mode():
        state = initialize_sampler_state(torch.Generator().manual_seed(seed), smpl, n_walkers,
                                         mols, dtype=torch.float32, device=device)
    gen = torch.Generator(device).manual_seed(seed + 1 + get_process_index())
    return idx_sampler, smpl, state, gen, grad_mode


def _equilibration(gen, idx_sampler, sampler, state, grad_mode, max_eq_steps,
                   allow_early_stopping):
    """Yields ``(step, state, mol_idxs, stats)`` of up to ``max_eq_steps`` sample calls,
    each under ``grad_mode``, with early stopping on the mean electron distance
    and the spread of log|psi| (``train.py:243-272``)."""
    steps = equilibrate(
        gen, idx_sampler, sampler, state,
        lambda pc: all_device_mean(pairwise_self_distance(pc.r)),  # the same stop on every rank
        range(max_eq_steps), block_size=EQ_BLOCK_SIZE, allow_early_stopping=allow_early_stopping,
    )
    while True:
        with grad_mode():  # left before each yield, so the caller's mode is its own
            item = next(steps, None)
        if item is None:
            return
        yield item


def evaluate(
    hamil, wf, *, n_walkers: int = 2048, steps: int = 3, decorr: int = 10, seed: int = 0,
    device=None, sampler=None, mols=None, molecule_batch_size: int = 1, max_eq_steps: int = 0,
    eq_allow_early_stopping: bool = True, eloc_walker_chunk=None,
) -> Iterator[tuple[int, dict, torch.Tensor, dict]]:
    """Evaluate ``wf`` on ``hamil``: yields ``(step, sampler_state, E_loc, stats)``.

    ``sampler`` is a recipe name of ``sampling.RECIPES``, a factory ``(hamil,
    wf) -> electron sampler``, or None for bench.py's Metropolis at ``decorr``
    moves a step.  ``mols`` are geometries of ``hamil.mol`` (same charges,
    charge and spin; default ``[hamil.mol]``), ``molecule_batch_size`` a step
    in a shuffled cycle (E_loc ``[m, 1, B]`` for m > 1, ``[B]`` for one).
    ``n_walkers`` is per molecule over all ranks (each holds its share).
    With ``max_eq_steps`` > 0 the walkers are first equilibrated: those
    sample calls are yielded first, each as ``(step, sampler_state, None,
    sampler_stats)``.  Runs on ``device`` (``None`` means CUDA, and raises where
    it is absent) in float32, with TF32 off.  Walkers start from
    ``hamil.init_sample`` drawn on the CPU from ``seed``; the moves draw from a
    generator on the device seeded with ``seed + 1`` plus the rank.  Each step runs under
    ``torch.inference_mode()``, or ``torch.no_grad()`` for a sampler whose
    force needs autograd (Langevin).  The local energy takes the walkers in
    chunks of ``eloc_walker_chunk`` (:func:`.loss.compute_local_energy`).
    """
    device = resolve_device(device)
    if device.type == 'cuda':
        set_true_fp32()
    wf = replicate_on_devices(wf.to(device=device, dtype=torch.float32))
    idx_sampler, sampler, state, gen, grad_mode = _sampling(
        hamil, wf, sampler=sampler, decorr=decorr, mols=mols,
        molecule_batch_size=molecule_batch_size, n_walkers=n_walkers, seed=seed, device=device,
        inference=True,
    )
    for step, state, _, stats in _equilibration(gen, idx_sampler, sampler, state, grad_mode,
                                                max_eq_steps, eq_allow_early_stopping):
        yield step, state, None, stats
    ewm, update_ewm = init_multi_mol_multi_state_ewm((idx_sampler.n_mols, 1), device=device)
    std_ewm = ewm
    for step in range(steps):
        with tracing.step(step), grad_mode():
            state, ewm, std_ewm, E_loc, stats = eval_step(
                gen, hamil, wf, sampler, state, idx_sampler.sample(), ewm, std_ewm, update_ewm,
                eloc_walker_chunk,
            )
        yield step, state, _public(E_loc), stats


def _public(E_loc: torch.Tensor) -> torch.Tensor:
    """The local energies ``[m, 1, B]`` of a step as :func:`evaluate` and
    :func:`train` yield them: ``[B]`` for one molecule."""
    return E_loc[0, 0] if len(E_loc) == 1 else E_loc


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
    ``(step, TrainState(sampler_state, params, None), None, sampler_stats)``.  A step
    takes ``molecule_batch_size`` molecules (E_loc ``[m, 1, B]`` for m > 1), and
    ``n_walkers`` of each over all ranks.  Runs on ``device``
    (``None`` means CUDA, and raises where it is absent) in float32 with TF32
    off; ``wf`` is moved there and its parameters are updated in place.
    Walkers start from ``hamil.init_sample`` drawn on the CPU from ``seed``; the
    moves draw from a generator on the device seeded with ``seed + 1`` plus the rank.
    """
    device = resolve_device(device)
    if device.type == 'cuda':
        set_true_fp32()
    wf = replicate_on_devices(wf.to(device=device, dtype=torch.float32))
    idx_sampler, sampler, smpl_state, gen, grad_mode = _sampling(
        hamil, wf, sampler=sampler, decorr=decorr, mols=mols,
        molecule_batch_size=molecule_batch_size, n_walkers=n_walkers, seed=seed, device=device,
        inference=False,
    )
    for step, smpl_state, _, stats in _equilibration(gen, idx_sampler, sampler, smpl_state,
                                                     grad_mode, max_eq_steps,
                                                     eq_allow_early_stopping):
        yield step, TrainState(smpl_state, wf.state_dict(), None), None, stats
    loss = create_loss_fn(hamil, wf, clip_mask_fn)
    opt = OPTIMIZERS[optimizer](loss, **(DEFAULT_OPT_KWARGS[optimizer] | opt_kwargs))
    for step, train_state, _, E_loc, _, stats in _fit_steps(
        gen, sampler, opt, TrainState(smpl_state, wf.state_dict(), None), idx_sampler,
        range(steps),
    ):
        yield step, train_state, _public(E_loc), stats


def _fit_steps(gen, sampler, opt, train_state: TrainState, molecule_idx_sampler,
               steps: Iterable, grad_mode=None):
    """The steps of :func:`train` and :func:`fit_wf`: initialises the EWM grids
    and, where ``train_state.opt`` is None, the optimizer's state; returns a
    generator of ``(step, train_state, mol_idxs, E_loc, psi_ratio, stats)``,
    one :func:`train_step` each, under ``grad_mode`` where one is given."""
    smpl_state, params, opt_state = train_state
    r = smpl_state['elec']['r']
    ewm, update_ewm = init_multi_mol_multi_state_ewm((molecule_idx_sampler.n_mols, r.shape[1]),
                                                     device=r.device)
    if opt_state is None:
        opt_state = opt.init(_state_conf(smpl_state, torch.tensor([0])))

    def run(train_state, ewm, std_ewm):
        for step in steps:
            mol_idxs = molecule_idx_sampler.sample()
            with tracing.step(step), grad_mode() if grad_mode else contextlib.nullcontext():
                train_state, ewm, std_ewm, E_loc, psi_ratio, stats = train_step(
                    gen, sampler, opt, train_state, mol_idxs, ewm, std_ewm, update_ewm)
            yield step, train_state, mol_idxs, E_loc, psi_ratio, stats

    return run(TrainState(smpl_state, params, opt_state), ewm, ewm)


def _to_host(tree):
    """``tree`` (dicts and named tuples) with its tensors as numpy arrays, in
    one copy per dtype."""
    leaves = []
    tree_map(lambda x: leaves.append(x) if isinstance(x, torch.Tensor) else None, tree)
    by_dtype: dict = {}
    for t in leaves:
        by_dtype.setdefault(t.dtype, []).append(t)
    host = {}
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts]).cpu().numpy()
        offset = 0
        for t in ts:
            host[id(t)] = flat[offset:offset + t.numel()].reshape(tuple(t.shape))
            offset += t.numel()
    return tree_map(lambda x: host[id(x)] if isinstance(x, torch.Tensor) else x, tree)


def _state_conf(smpl_state: dict, mol_idxs) -> PhysicalConfiguration:
    """The walkers of the molecules ``mol_idxs`` as the sampler left them: the
    configuration the step's local energy was taken on."""
    idxs = mol_idxs.tolist()
    r = _rows(smpl_state['elec']['r'], idxs)
    mol_idx = torch.tensor(idxs, device=r.device)[:, None, None].expand(r.shape[:3])
    return PhysicalConfiguration(_rows(smpl_state['nuc']['R'], idxs), r, mol_idx)


def fit_wf(
    gen, hamil, wf, optimizer_factory, molecule_idx_sampler, sampler, steps: Iterable,
    train_state: TrainState, loss_function_factory, observable_monitors: list,
    block_size: int = 1, grad_mode=torch.no_grad,
) -> Generator[tuple[int, TrainState, np.ndarray, dict, dict], None, None]:
    """The fit loop of ``deepqmc_tpu/fit.py:48-378`` over :func:`train_step`:
    yields ``(step, train_state, mol_idxs, stats, observable_samples)`` with
    stats and samples as numpy arrays.

    ``optimizer_factory(loss)`` makes the optimizer (``NoOptimizer`` for an
    evaluation, whose steps run under ``grad_mode``); ``loss_function_factory
    (hamil, wf)`` the loss.  ``train_state.params``, where given, is loaded
    into ``wf``; an optimizer state of None is initialised.  ``block_size``
    steps run between two reads of their outputs on the host; the energy and
    wave-function statistics (``local_energy/*``, ``energy/*``, the samples
    ``local_energy/samples`` and ``psi/samples``) come from every step, other
    monitors run on the last step of a block.  ``perf/step_time`` is the
    block's wall time over its steps.
    """
    from .observable import EnergyMonitor, WaveFunctionMonitor

    opt = optimizer_factory(loss_function_factory(hamil, wf))
    is_evaluation = isinstance(opt, NoOptimizer)
    observable_monitors = [m for m in observable_monitors
                           if not isinstance(m, (EnergyMonitor, WaveFunctionMonitor))]
    if train_state.params is not None:
        wf.load_state_dict(train_state.params)
        replicate_on_devices(wf)
    run = _fit_steps(gen, sampler, opt, train_state._replace(params=wf.state_dict()),
                     molecule_idx_sampler, steps, grad_mode if is_evaluation else None)
    r = train_state.sampler['elec']['r']
    n_walkers = int(np.prod(r.shape[:3])) * get_process_count()
    while True:
        start, block, outputs = time.perf_counter(), [], []
        for step, train_state, mol_idxs, E_loc, psi_ratio, stats in itertools.islice(
                run, block_size):
            block.append(step)
            psi = train_state.sampler['elec']['psi']
            outputs.append((mol_idxs, E_loc, psi, psi_ratio, {
                'stats': {k: torch.as_tensor(v, dtype=torch.float32, device=r.device)
                          for k, v in stats.items()},
                'E_loc': E_loc, 'psi_sign': psi.sign, 'psi_log': psi.log,
            }))
        if not block:
            return
        with tracing.span('fit.host_read'):
            host = _to_host(dict(enumerate(out for *_, out in outputs))).values()
        step_time = (time.perf_counter() - start) / len(block)
        for b, (step, (mol_idxs, E_loc, psi, psi_ratio, _), out) in enumerate(
                zip(block, outputs, host)):
            stats = {**out['stats'], 'perf/step_time': step_time,
                     'perf/walker_steps_per_sec': n_walkers / step_time}
            samples = {'local_energy/samples': out['E_loc'],
                       'psi/samples': {'sign': out['psi_sign'], 'log': out['psi_log']}}
            if b == len(block) - 1 and observable_monitors:
                with tracing.span('fit.monitors'):
                    for monitor in observable_monitors:
                        extra = monitor(step, train_state.params,
                                        _state_conf(train_state.sampler, mol_idxs), psi, E_loc,
                                        psi_ratio)
                        extra_samples, extra_stats = split_dict(extra,
                                                                lambda key: 'samples' in key)
                        stats |= _to_host(extra_stats)
                        samples |= _to_host(extra_samples)
            yield step, train_state, mol_idxs.numpy(), stats, samples
