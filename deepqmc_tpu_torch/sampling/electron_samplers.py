"""Electron-position MCMC samplers (counterpart of
``deepqmc_tpu/sampling/electron_samplers.py``) for one molecule and one
electronic state: random-walk Metropolis with an adaptive step size and an
optional forced move of stuck walkers, Metropolis-adjusted Langevin along the
regularised quantum force, and the decorrelating and resampling wrappers.

The sampler state is a dict: the walker entries (``WALKER_STATE``: ``r``
``[B, n, 3]``, ``psi`` (the cached ``Psi``), ``age`` ``[B]``, and for Langevin
the cleaned ``force`` ``[B, n, 3]``), ``tau`` (a scalar tensor) and, under
:class:`ResampledSampler`, ``step`` and ``log_weight`` ``[B]``.  Random numbers
come from an explicit ``torch.Generator`` through :func:`normal` and
:func:`uniform`; :meth:`MetropolisSampler.step` takes them as arguments, so a
test can feed the same numbers to a reference.

With the walkers sharded over processes, each rank moves its own; the
acceptance that steers ``tau``, the statistics, and the effective sample size
and resampling decision of :class:`ResampledSampler` are over the global
walker axis (as the JAX package's global arrays give them), so ``tau`` and
the decision are the same on every rank.  The resampling draws each rank's
walkers from its own shard in proportion to the weights.
"""

import torch

from .. import tracing
from ..parallel import (
    all_device_max,
    all_device_mean,
    all_device_std,
    all_device_sum,
    shard_walkers,
)
from ..physics import pairwise_self_distance
from ..types import PhysicalConfiguration, Psi
from ..utils import multinomial_resampling
from .sampling_utils import clean_force

__all__ = ['DecorrSampler', 'LangevinSampler', 'MetropolisSampler', 'ResampledSampler']


def normal(gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """Standard-normal draws of the shape, dtype and device of ``like``."""
    return torch.randn(like.shape, generator=gen, dtype=like.dtype, device=like.device)


def uniform(gen: torch.Generator, n: int, like: torch.Tensor) -> torch.Tensor:
    """``n`` uniform draws on [0, 1) of the dtype and device of ``like``."""
    return torch.rand(n, generator=gen, dtype=like.dtype, device=like.device)


def _pick(accepted, new, old):
    """Per walker: ``new`` where accepted, else ``old`` (a tensor or a ``Psi``)."""
    if isinstance(new, Psi):
        return Psi(*(_pick(accepted, n, o) for n, o in zip(new, old)))
    return torch.where(accepted.view(-1, *(1,) * (new.dim() - 1)), new, old)


class MetropolisSampler:
    """Random-walk Metropolis-Hastings with an adaptive step size.

    ``tau`` is the initial proposal scale; while ``target_acceptance`` is set,
    ``tau`` is scaled by max(acceptance, 0.05) / target_acceptance after each
    move; a walker not moved for ``max_age`` moves is accepted whatever its
    ratio (0 and None turn that off, as in the JAX package).
    """

    WALKER_STATE = ('r', 'psi', 'age')
    uses_autograd = False

    def __init__(self, hamil, wf, *, tau: float = 1.0, target_acceptance=0.57, max_age=None):
        self.hamil = hamil
        self.wf = wf
        self.initial_tau = tau
        self.target_acceptance = target_acceptance
        self.max_age = max_age

    @staticmethod
    def phys_conf(R, r) -> PhysicalConfiguration:
        return PhysicalConfiguration(R, r, torch.zeros(r.shape[0], dtype=torch.long, device=r.device))

    def _update(self, state: dict, R) -> dict:
        return {**state, 'psi': self.wf(self.phys_conf(R, state['r']))}

    def update(self, state: dict, R) -> dict:
        """Refresh the cached psi of the walkers (after a parameter change)."""
        return self._update(state, R)

    def init(self, gen: torch.Generator, n: int, R) -> dict:
        """Walkers from ``hamil.init_sample`` around the nuclei ``R``, drawn
        with ``gen`` (any device), moved to the device and dtype of ``R``:
        ``n`` over all ranks, drawn whole, of which this rank keeps its share
        before its first psi (:func:`..parallel.shard_walkers`)."""
        r = shard_walkers(self.hamil.init_sample(gen, n, R).r, walker_axis=0)
        r = r.to(R.device, R.dtype)
        state = {
            'r': r,
            'age': torch.zeros(len(r), dtype=torch.long, device=R.device),
            'tau': torch.tensor(self.initial_tau, dtype=R.dtype, device=R.device),
        }
        return self._update(state, R)

    def _proposal(self, state: dict, noise):
        return state['r'] + state['tau'] * noise

    def _acc_log_prob(self, state: dict, prop: dict):
        return 2 * (prop['psi'].log - state['psi'].log)

    def step(self, state: dict, R, noise, uniforms):
        """One move given standard-normal ``noise`` ``[B, n, 3]`` and uniform
        ``uniforms`` ``[B]``; returns (state, phys_conf, stats)."""
        candidate = self._update({
            'r': self._proposal(state, noise),
            'age': torch.zeros_like(state['age']),
            **{k: v for k, v in state.items() if k not in self.WALKER_STATE},
        }, R)
        accepted = self._acc_log_prob(state, candidate) > torch.log(uniforms)
        if self.max_age:  # stuck walkers move, so no region stays frozen
            accepted = accepted | (state['age'] >= self.max_age)
        acceptance = all_device_mean(accepted.to(state['r'].dtype))
        if self.target_acceptance:
            candidate['tau'] = candidate['tau'] * (
                torch.clamp(acceptance, min=0.05) / self.target_acceptance
            )
        old = {**state, 'age': state['age'] + 1}
        state = {  # walker entries per walker, the rest from the candidate
            k: _pick(accepted, v, old[k]) if k in self.WALKER_STATE else v
            for k, v in candidate.items()
        }
        stats = {'sampling/acceptance': acceptance, **self._stats(state)}
        return state, self.phys_conf(R, state['r']), stats

    def sample(self, gen: torch.Generator, state: dict, R):
        r = state['r']
        with tracing.span('sampling.move'):
            return self.step(state, R, normal(gen, r), uniform(gen, r.shape[0], r))

    @staticmethod
    def _stats(state) -> dict:
        return {
            'sampling/tau': state['tau'],
            'sampling/age/mean': all_device_mean(state['age'].to(state['r'].dtype)),
            'sampling/age/max': all_device_max(state['age']),
            'sampling/log_psi/mean': all_device_mean(state['psi'].log),
            'sampling/log_psi/std': all_device_std(state['psi'].log),
            'sampling/dists/mean': all_device_mean(pairwise_self_distance(state['r'])),
        }


class LangevinSampler(MetropolisSampler):
    """Metropolis-adjusted Langevin: the proposal drifts along the quantum
    force grad log|psi|, regularised by :func:`clean_force` with the walker's
    ``tau``; the acceptance carries the ratio of the Green's functions.

    The force is ``torch.autograd.grad`` of the plain forward with respect to
    the electrons only: the parameters get no ``.grad``.  Autograd must be
    available, so the sampler runs under ``torch.no_grad()`` (it turns
    gradients back on locally), never under ``torch.inference_mode()``.
    """

    WALKER_STATE = (*MetropolisSampler.WALKER_STATE, 'force')
    uses_autograd = True

    def _update(self, state: dict, R) -> dict:
        if torch.is_inference_mode_enabled():
            raise RuntimeError('LangevinSampler takes the force by autograd: run it under '
                               'torch.no_grad(), not torch.inference_mode()')
        with torch.enable_grad():
            r = state['r'].detach().requires_grad_()
            psi = self.wf(self.phys_conf(R, r))
            (force,) = torch.autograd.grad(psi.log.sum(), r)
        force = clean_force(force, self.phys_conf(R, state['r']), self.hamil.mol,
                            tau=state['tau'])
        return {**state, 'psi': Psi(psi.sign.detach(), psi.log.detach()), 'force': force}

    def _proposal(self, state: dict, noise):
        tau = state['tau']
        return state['r'] + tau * state['force'] + torch.sqrt(tau) * noise

    def _acc_log_prob(self, state: dict, prop: dict):
        log_G_ratios = (
            (state['force'] + prop['force'])
            * ((state['r'] - prop['r']) + state['tau'] / 2 * (state['force'] - prop['force']))
        ).sum((-1, -2))
        return log_G_ratios + 2 * (prop['psi'].log - state['psi'].log)


class _Wrapped:
    """A wrapper around a sampler; what it does not define, the inner one does."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        if name == 'inner':  # not yet set (a copy being made): no recursion
            raise AttributeError(name)
        return getattr(self.inner, name)


class DecorrSampler:
    """``length`` MCMC moves per sample call; the stats are the last move's."""

    def __init__(self, *, length: int):
        self.length = length

    def wrap(self, inner):
        return _Decorr(inner, self.length)


class _Decorr(_Wrapped):
    def __init__(self, inner, length):
        super().__init__(inner)
        self.length = length

    def sample(self, gen, state, R):
        for _ in range(self.length):
            state, phys_conf, stats = self.inner.sample(gen, state, R)
        return state, phys_conf, stats


class ResampledSampler:
    """Importance weights and multinomial resampling of the walkers.

    Between resamplings each walker's ``log_weight`` follows the change of
    log |psi|^2 under parameter updates (:meth:`update`); the walkers are
    resampled in proportion to their weights once ``period`` sample calls have
    passed or the effective sample size per walker falls below ``threshold``.
    """

    def __init__(self, *, period=None, threshold=None):
        if period is None and threshold is None:
            raise ValueError('ResampledSampler needs a period or a threshold')
        self.period, self.threshold = period, threshold

    def wrap(self, inner):
        return _Resampled(inner, self.period, self.threshold)


class _Resampled(_Wrapped):
    def __init__(self, inner, period, threshold):
        super().__init__(inner)
        self.period, self.threshold = period, threshold

    def init(self, gen, n, R):
        state = self.inner.init(gen, n, R)
        return {
            **state,
            'step': torch.zeros((), dtype=torch.long, device=R.device),
            'log_weight': torch.zeros_like(state['psi'].log),
        }

    def update(self, state, R):
        log_weight = state['log_weight'] - 2 * state['psi'].log
        state = self.inner.update(state, R)
        log_weight = log_weight + 2 * state['psi'].log
        return {**state, 'log_weight': log_weight - all_device_max(log_weight)}

    def sample(self, gen, state, R):
        """The inner sample call, then the resampling where it is due, decided
        on the device: the walkers are gathered by the drawn indices or by the
        identity, so no host sync."""
        state, _, stats = self.inner.sample(gen, state, R)
        state = {**state, 'step': state['step'] + 1}
        weight = torch.exp(state['log_weight'])
        uniforms = uniform(gen, len(weight), weight)
        ess = all_device_sum(weight) ** 2 / all_device_sum(weight**2)
        stats = {**stats, 'sampling/effective sample size': ess}
        due = torch.zeros((), dtype=torch.bool, device=weight.device)
        if self.period is not None:
            due = due | (state['step'] >= self.period)
        if self.threshold is not None:
            due = due | (ess / all_device_sum(torch.ones_like(weight)) < self.threshold)
        idx = torch.where(due, multinomial_resampling(weight, uniforms),
                          torch.arange(len(weight), device=weight.device))
        state = {
            k: (Psi(*(t[idx] for t in v)) if isinstance(v, Psi) else v[idx])
            if k in self.inner.WALKER_STATE else v
            for k, v in state.items()
        }
        state['step'] = torch.where(due, torch.zeros_like(state['step']), state['step'])
        state['log_weight'] = torch.where(due, torch.zeros_like(state['log_weight']),
                                          state['log_weight'])
        return state, self.inner.phys_conf(R, state['r']), stats
