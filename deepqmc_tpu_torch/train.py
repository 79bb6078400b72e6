"""The training and evaluation run (counterpart of ``deepqmc_tpu/train.py``).

A :class:`TrainSession` owns the run's three phases: SCF pretraining of the
orbitals (``pretrain_phase``), equilibration of fresh walkers
(``equilibration_phase``) and the fit loop (``fit_phase``, over
:func:`.fit.fit_wf`); :class:`RunSinks` groups the checkpoints and the metric
and HDF5 sinks of a work directory.  :func:`train` chains them and rewinds to
the last checkpoint when the sampled wave function turns NaN.  Evaluation is
the same run with ``opt=None``, usually from a checkpoint's train state.
Progress goes to ``logging``.

One or more molecules a step, on one process or on several (one per GPU,
the walkers sharded, :mod:`.parallel`): each process seeds its generators
with ``seed`` plus its index, but draws the molecule indices from ``seed``
alone, so every rank steps the same molecules; rank 0's parameters are
broadcast at the start and after a restart; with more than one process each
writes into its own work directory, ``training_<index>``.  The parameters
live in the wave-function module, one per electronic state (a
:class:`~.wf.StateStack` for several; ``TrainState.params`` is its
``state_dict``).
"""

import json
import logging
import math
import os
import time
from collections.abc import Callable, Sequence
from functools import partial
from typing import Optional

import numpy as np
import torch

from .ewm import init_multi_mol_multi_state_ewm
from .exceptions import NanError, TrainingBlowup, TrainingCrash
from .fit import TrainState, _equilibration, fit_wf, sampling_grad_mode
from .log import (
    CheckpointStore,
    H5Logger,
    MetricLogger,
    TensorboardMetricLogger,
    copy_train_state,
)
from .loss import create_loss_fn, median_log_squeeze_and_mask
from .molecule import Molecule
from .observable import ObservableMonitor, default_observable_monitors
from .ops import launch_counts
from .optimizer import PRETRAIN_OPTIMIZERS, NoOptimizer
from .parallel import (
    all_device_mean,
    any_rank,
    get_process_count,
    get_process_index,
    replicate_on_devices,
)
from .sampling import initialize_sampler_state
from .utils import resolve_device, set_true_fp32
from .wf.base import StateStack, init_wf_states, merge_states

__all__ = ['train']

log = logging.getLogger(__name__)


def format_uncertainty(mean: float, err: float) -> str:
    """'-8.0700(19)'-style formatting of a value with uncertainty."""
    if not np.isfinite(mean) or not np.isfinite(err) or err <= 0:
        return f'{mean:.4f}(nan)'
    digits = max(0, -int(math.floor(math.log10(err))) + 1)
    err_digits = round(err * 10**digits)
    return f'{mean:.{digits}f}({err_digits})'


def process_idx_suffix() -> str:
    """``_<index>`` of this process where there are several, else nothing."""
    return f'_{get_process_index()}' if get_process_count() > 1 else ''


def _grid_repr(values, fmt) -> str:
    """'(a|b)|(c|d)' rendering of a [mol, state] grid of numbers."""
    return '|'.join(
        '(' + '|'.join(fmt(v) for v in np.atleast_1d(row)) + ')' for row in np.asarray(values)
    )


def _numpy(tree):
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


class RunSinks:
    """The host-side outputs of a run: checkpoints, metrics, HDF5.

    Inactive (all sinks ``None``) when no workdir is given; ``close()`` is
    safe either way.  Checkpoints load onto ``device``.
    """

    def __init__(self, workdir, mode, monitor_names, mols, molecule_batch_size, init_step,
                 chkpt_constructor, metric_logger_constructor, h5_logger_constructor, device):
        self.workdir = None
        self.chkpts: Optional[CheckpointStore] = None
        self.metrics: Optional[MetricLogger] = None
        self.h5: Optional[H5Logger] = None
        self.start_time = time.time()
        if not workdir:
            return
        self.workdir = os.path.join(workdir, mode + process_idx_suffix())
        os.makedirs(self.workdir, exist_ok=True)
        self.chkpts = (chkpt_constructor or CheckpointStore)(self.workdir, device=device)
        self.metrics = (metric_logger_constructor or TensorboardMetricLogger)(
            self.workdir, molecule_batch_size
        )
        self.h5 = (h5_logger_constructor or H5Logger)(
            self.workdir, list(monitor_names), init_step=init_step,
            aux_data={f'mol-{i}': np.asarray(m.coords) for i, m in enumerate(mols)},
        )

    def log_metrics(self, step, stats, single_stats, mol_idxs, prefix=None):
        if self.metrics:
            kwargs = {'prefix': prefix} if prefix else {}
            self.metrics.update(step, _numpy(stats), _numpy(single_stats), np.asarray(mol_idxs),
                                **kwargs)

    def close(self):
        for sink in (self.chkpts, self.metrics, self.h5):
            if sink is not None:
                sink.close()


class TrainSession:
    """One training or evaluation run, split into its three phases.

    Each phase draws from its own generator, derived from ``seed`` plus the
    process index and the count of generators drawn before it; the
    molecule-index sampler's from ``seed`` alone, the same on every rank.
    """

    def __init__(self, hamil, ansatz, opt, sampler_factory, *, seed, electron_batch_size,
                 molecule_batch_size, electronic_states, mols, observable_monitors, device,
                 merge_keys=None):
        self.hamil = hamil
        self.seed, self._forks = seed + get_process_index(), 0
        self.ansatz = replicate_on_devices(self.init_states(
            ansatz, electronic_states, merge_keys).to(device=device, dtype=torch.float32))
        self.opt_factory = opt or NoOptimizer
        if opt is not None and merge_keys:
            self.opt_factory = partial(opt, merge_keys=merge_keys)
        self.mode = 'evaluation' if opt is None else 'training'
        self.device = device
        self.electron_batch_size = electron_batch_size
        self.electronic_states = electronic_states
        self.mols = list(mols) if isinstance(mols, Sequence) else [hamil.mol]
        self.molecule_idx_sampler, self.sampler = sampler_factory(
            self._fork_gen('cpu', seed), hamil, self.ansatz, self.mols, electronic_states,
            molecule_batch_size,
        )
        self.monitors = default_observable_monitors() + (observable_monitors or [])
        # training walkers must stay usable by autograd
        self.grad_mode = sampling_grad_mode(self.sampler, inference=self.mode == 'evaluation')
        self.step = None  # the step being run, for the crash report

    def init_states(self, ansatz, n_states: int, merge_keys):
        """The wave function of ``n_states`` states: ``ansatz`` itself where
        it is a module (one state) or a :class:`~.wf.StateStack` of
        ``n_states``; for a factory ``gen -> module`` one module per state,
        each from its own forked generator, the ``merge_keys`` bundles
        averaged over the states (``deepqmc_tpu.wf.init_wf_params``)."""
        if isinstance(ansatz, StateStack):
            if len(ansatz) != n_states:
                raise ValueError(f'a stack of {len(ansatz)} states for {n_states} states')
            merge_states(ansatz, merge_keys)
            return ansatz
        if isinstance(ansatz, torch.nn.Module):
            if n_states != 1:
                raise ValueError(f'{n_states} electronic states need a StateStack or a factory '
                                 'gen -> module as the ansatz, not one module')
            return ansatz
        if n_states == 1:
            return ansatz(gen=self._fork_gen('cpu'))
        return init_wf_states(ansatz, [self._fork_gen('cpu') for _ in range(n_states)],
                              merge_keys)

    def _fork_gen(self, device=None, seed=None):
        """A fresh generator on ``device`` (the run's by default), from the
        process's seed or the ``seed`` given."""
        seed = self.seed if seed is None else seed
        seed = int(np.random.SeedSequence([seed, self._forks]).generate_state(1)[0])
        self._forks += 1
        return torch.Generator(device or self.device).manual_seed(seed)

    def _init_walkers(self):
        with self.grad_mode():
            return initialize_sampler_state(self._fork_gen('cpu'), self.sampler,
                                            self.electron_batch_size, self.mols,
                                            dtype=torch.float32, device=self.device)

    # -- phases ----------------------------------------------------------------

    def pretrain_phase(self, n_steps, kwargs, sinks: RunSinks):
        """Fit the orbitals to an SCF baseline before variational optimization;
        the parameters of the ansatz change in place."""
        from . import pretrain as pretraining

        log.info('Pretraining wrt. baseline wave function')
        kwargs = dict(kwargs or {})
        t0 = time.perf_counter()
        dataset = pretraining.compute_scf_solution(
            self.mols, self.hamil, self.electronic_states,
            workdir=kwargs.pop('pyscf_chkpt_path', None) or sinks.workdir,
            **kwargs.pop('scf_kwargs', {}),
        )
        scf_seconds = time.perf_counter() - t0
        log.info(f'SCF solution in {scf_seconds:.2f} s', extra={'scf_seconds': scf_seconds})
        name = kwargs.pop('opt', 'adam')
        if name not in PRETRAIN_OPTIMIZERS:
            raise ValueError(f'pretraining optimizer {name!r}: the port has '
                             f'{sorted(PRETRAIN_OPTIMIZERS)}')
        opt = PRETRAIN_OPTIMIZERS[name](**kwargs.pop('opt_kwargs', {'learning_rate': 3.0e-4}))
        mse_ewm, update_ewm = init_multi_mol_multi_state_ewm(
            (len(self.mols), self.electronic_states), decay_alpha=1.0
        )
        smpl_state = self._init_walkers()
        mse_rep = None
        for step, losses, mol_idxs in pretraining.pretrain(
            self._fork_gen(), self.hamil, self.ansatz, opt, self.molecule_idx_sampler,
            self.sampler, smpl_state, dataset, steps=range(n_steps),
        ):
            per_mol = all_device_mean(losses, -1).double().cpu()
            mse_ewm = update_ewm(per_mol, mse_ewm, mol_idxs)
            mse_rep = _grid_repr(mse_ewm.mean, '{:0.2e}'.format)
            log.debug(f'pretrain {step + 1}/{n_steps}: MSE={mse_rep}')
            sinks.log_metrics(step, {'MSE': per_mol, 'MSE/ewm': mse_ewm.mean}, {}, mol_idxs,
                              prefix='pretraining')
        log.info(f'Pretraining completed with MSE = {mse_rep}')

    def equilibration_phase(self, max_eq_steps, allow_early_stopping, sinks: RunSinks):
        """Burn in fresh walkers until their spread statistic stabilizes."""
        smpl_state = self._init_walkers()
        log.info('Equilibrating sampler...')
        for step, smpl_state, mol_idxs, smpl_stats in _equilibration(
            self._fork_gen(), self.molecule_idx_sampler, self.sampler, smpl_state,
            self.grad_mode, max_eq_steps, allow_early_stopping,
        ):
            if log.isEnabledFor(logging.DEBUG):
                log.debug(f'equilibrate sampler {step + 1}: tau='
                          + _grid_repr(smpl_state['elec']['tau'].cpu(), '{:.3f}'.format))
            sinks.log_metrics(step, {}, smpl_stats, mol_idxs, prefix='equilibration')
        return smpl_state

    def fit_phase(self, train_state: TrainState, steps_range, loss_function_factory,
                  fit_block_size: int, sinks: RunSinks, progress: 'ProgressTracker'):
        """The optimization loop proper; mutates the sinks."""
        for step, train_state, mol_idxs, stats, samples in fit_wf(
            self._fork_gen(), self.hamil, self.ansatz, self.opt_factory,
            self.molecule_idx_sampler, self.sampler, steps_range, train_state,
            loss_function_factory,
            observable_monitors=[m.finalize(self.hamil, self.ansatz) for m in self.monitors],
            block_size=fit_block_size, grad_mode=self.grad_mode,
        ):
            self.step = step
            progress.update(step, steps_range.stop, mol_idxs, stats)
            if log.isEnabledFor(logging.DEBUG):
                log.debug(f'{self.mode} step {step}: ' + json.dumps({
                    'step_time': float(stats['perf/step_time']),
                    'E_mean': float(np.mean(np.asarray(stats['local_energy/mean']))),
                    'launches': launch_counts()}))
            if any_rank(np.isnan(samples['psi/samples']['log']).any()):
                raise NanError()
            if sinks.workdir:
                if self.mode == 'training' and sinks.chkpts:
                    # chkpt-i contains the step i-1 -> i
                    sinks.chkpts.update(step + 1, train_state,
                                        float(np.asarray(stats['local_energy/std']).mean()))
                sinks.log_metrics(step, stats, {}, mol_idxs)
                if sinks.h5:
                    sinks.h5.update({**samples, 'mol_idxs': mol_idxs, 'step': step,
                                     'time': time.time() - sinks.start_time, **stats})
        return train_state


class ProgressTracker:
    """EWM-energy progress rendering and improvement logging."""

    def __init__(self, n_mols: int, n_states: int):
        self.energies = [[(float('nan'), 1.0)] * n_states for _ in range(n_mols)]
        self.best = None

    def update(self, step, total, mol_idxs, stats):
        means = np.asarray(stats['energy/ewm'])
        errs = np.asarray(stats['energy/ewm_error'])
        for i, mol_idx in enumerate(np.asarray(mol_idxs)):
            self.energies[mol_idx] = [
                (float(m), float(s))
                for m, s in zip(np.atleast_1d(means[i]), np.atleast_1d(errs[i]))
            ]
        rendered = '|'.join(
            '(' + '|'.join(format_uncertainty(m, s) for m, s in row) + ')'
            for row in self.energies
        )
        log.debug(f'{step + 1}/{total}: E={rendered}')
        # a nan best (EWM warmup) must not freeze the log: treat it as
        # always-improvable, otherwise `s < 0.5 * nan` never fires again
        halved = self.best is None or any(
            not np.isfinite(best_s) or s < 0.5 * best_s
            for row, best_row in zip(self.energies, self.best)
            for (_, s), (_, best_s) in zip(row, best_row)
        )
        if halved:
            self.best = [list(row) for row in self.energies]
            log.info(f'Progress: {step + 1}/{total}, energy = {rendered}')


def train(
    hamil,
    ansatz,
    opt,
    sampler_factory: Callable,
    steps: int,
    seed: int,
    electron_batch_size: int,
    molecule_batch_size: int = 1,
    electronic_states: int = 1,
    mols: Optional[list[Molecule]] = None,
    workdir: Optional[str] = None,
    train_state: Optional[TrainState] = None,
    init_step: int = 0,
    max_restarts: int = 3,
    max_eq_steps: int = 1000,
    eq_allow_early_stopping: bool = True,
    pretrain_steps: Optional[int] = None,
    pretrain_kwargs: Optional[dict] = None,
    chkpt_constructor=None,
    metric_logger_constructor=None,
    h5_logger_constructor=None,
    merge_keys: Optional[list[str]] = None,
    loss_function_factory=None,
    observable_monitors: Optional[list[ObservableMonitor]] = None,
    fit_block_size: int = 1,
    device=None,
) -> TrainState:
    """Train or evaluate the wave function ``ansatz`` (``deepqmc_tpu/train.py``'s
    ``train``); returns the final :class:`~.fit.TrainState`.

    ``opt`` is an optimizer factory taking the loss (``partial(KFACOptimizer,
    ...)``, ``partial(AdamOptimizer, lr=...)``), or None for an evaluation.
    ``sampler_factory(gen, hamil, ansatz, mols, electronic_states,
    molecule_batch_size)`` gives the molecule-index sampler and the combined
    sampler (``partial(sampling.initialize_sampling, elec_sampler=...)``).
    ``loss_function_factory(hamil, ansatz)`` defaults to the VMC loss with
    ``median_log_squeeze_and_mask``.  ``pretrain_kwargs`` takes ``opt``
    ('adam' or 'lamb'), ``opt_kwargs``, ``scf_kwargs`` and
    ``pyscf_chkpt_path``.  With ``workdir`` the run writes to
    ``workdir/training`` (or ``evaluation``): checkpoints
    ``chkpt-{step}.pt`` (``chkpt_constructor``, :class:`~.log.CheckpointStore`
    by default), metrics (``metric_logger_constructor``, TensorBoard by
    default) and ``result.h5`` (``h5_logger_constructor``), each off with
    :func:`.log.no_sink`; a NaN in the
    sampled psi rewinds to the last checkpoint, at most ``max_restarts`` times,
    then raises :class:`~.exceptions.TrainingCrash`.

    ``ansatz`` is a module (one state), a :class:`~.wf.StateStack` of
    ``electronic_states`` modules, or a factory ``gen -> module`` (such as
    ``partial(psiformer_ansatz, hamil)``) that the session calls once per
    state, each with a generator forked from ``seed``.  With several states
    ``loss_function_factory`` must give the overlap penalty's ``alpha`` and
    ``clip_mask_overlap_fn``; the parameters whose JAX module path contains
    one of ``merge_keys`` are averaged over the states at the start and after
    every optimizer step, so they stay bitwise equal.  A step takes
    ``molecule_batch_size`` molecules of ``mols``, the same on every rank;
    ``electron_batch_size`` is the walkers of a molecule over all ranks.

    Runs on ``device`` (None means CUDA, and raises where it is absent) in
    float32 with TF32 off; the wave function is moved there and trained in
    place (``TrainState.params`` is its ``state_dict``; for a factory, load it
    into a :class:`~.wf.StateStack` of fresh modules to keep them).
    """
    device = resolve_device(device)
    if device.type == 'cuda':
        set_true_fp32()
    session = TrainSession(
        hamil, ansatz, opt, sampler_factory, seed=seed,
        electron_batch_size=electron_batch_size, molecule_batch_size=molecule_batch_size,
        electronic_states=electronic_states, mols=mols,
        observable_monitors=observable_monitors, device=device, merge_keys=merge_keys,
    )
    ansatz = session.ansatz
    sinks = RunSinks(
        workdir, session.mode, [m.name for m in session.monitors], session.mols,
        molecule_batch_size, init_step, chkpt_constructor, metric_logger_constructor,
        h5_logger_constructor, device,
    )
    loss_function_factory = loss_function_factory or partial(
        create_loss_fn, clip_mask_fn=median_log_squeeze_and_mask
    )
    try:
        if train_state:
            if train_state.params is not None:
                ansatz.load_state_dict(train_state.params)
                replicate_on_devices(ansatz)
            log.info(f'Restart training from step {init_step}' if session.mode == 'training'
                     else 'Start evaluation')
        else:
            if pretrain_steps and session.mode == 'training':
                session.pretrain_phase(pretrain_steps, pretrain_kwargs, sinks)
            train_state = TrainState(None, ansatz.state_dict(), None)
        if train_state.sampler is None:
            smpl_state = session.equilibration_phase(max_eq_steps, eq_allow_early_stopping,
                                                     sinks)
            train_state = TrainState(smpl_state, train_state.params, None)
            if sinks.chkpts and session.mode == 'training':
                sinks.chkpts.update(init_step, train_state)
            log.info(f'Start {session.mode}')

        progress = ProgressTracker(len(session.mols), electronic_states)
        # without checkpoints a restart begins where this run began; the
        # parameters change in place, so keep a copy of that state
        start = None if sinks.chkpts else (init_step, copy_train_state(train_state))
        for attempt in range(max_restarts):
            session.step = init_step
            try:
                train_state = session.fit_phase(train_state, range(init_step, steps),
                                                loss_function_factory, fit_block_size, sinks,
                                                progress)
                log.info(f'The {session.mode} has been completed!')
                if device.type == 'cuda':
                    log.info('Peak device memory: '
                             f'{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB')
                return train_state
            except (NanError, TrainingBlowup) as e:
                log.warning(f'Restarting due to {type(e).__name__}...')
                if attempt < max_restarts and sinks.chkpts and sinks.chkpts.chkpts:
                    init_step, train_state = sinks.chkpts.last
                    session._fork_gen()
                elif start is not None:
                    init_step, train_state = start[0], copy_train_state(start[1])
        log.warning(f'The {session.mode} has crashed before all steps were completed'
                    f' ({session.step}/{steps})!')
        raise TrainingCrash(train_state)
    finally:
        sinks.close()
