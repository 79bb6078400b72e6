"""Electron-position MCMC samplers (counterpart of
``deepqmc_tpu/sampling/electron_samplers.py``): random-walk Metropolis with an
adaptive step size, and the decorrelating wrapper, for one molecule and one
electronic state.

The sampler state is a dict: ``r`` ``[B, n, 3]``, ``psi`` (the cached
``Psi`` of the walkers), ``age`` ``[B]`` and ``tau`` (a scalar tensor).
Random numbers come from an explicit ``torch.Generator``; :meth:`MetropolisSampler.step`
takes them as arguments, so a test can feed the same numbers to a reference.
"""

import torch

from ..physics import pairwise_self_distance
from ..types import PhysicalConfiguration, Psi

__all__ = ['DecorrSampler', 'MetropolisSampler']


class MetropolisSampler:
    """Random-walk Metropolis-Hastings; ``tau`` adapts toward an acceptance of 0.57."""

    TARGET_ACCEPTANCE = 0.57

    def __init__(self, hamil, wf, *, tau: float = 1.0):
        self.hamil = hamil
        self.wf = wf
        self.initial_tau = tau

    @staticmethod
    def phys_conf(R, r) -> PhysicalConfiguration:
        return PhysicalConfiguration(R, r, torch.zeros(r.shape[0], dtype=torch.long, device=r.device))

    def update(self, state: dict, R) -> dict:
        """Refresh the cached psi of the walkers (after a parameter change)."""
        return {**state, 'psi': self.wf(self.phys_conf(R, state['r']))}

    def init(self, gen: torch.Generator, n: int, R) -> dict:
        """Walkers from ``hamil.init_sample`` drawn with ``gen`` (any device),
        moved to the device and dtype of ``R``."""
        r = self.hamil.init_sample(gen, n).r.to(R.device, R.dtype)
        state = {
            'r': r,
            'age': torch.zeros(n, dtype=torch.long, device=R.device),
            'tau': torch.tensor(self.initial_tau, dtype=R.dtype, device=R.device),
        }
        return self.update(state, R)

    def step(self, state: dict, R, noise, uniforms):
        """One Metropolis move given standard-normal ``noise`` ``[B, n, 3]`` and
        uniform ``uniforms`` ``[B]``."""
        r_prop = state['r'] + state['tau'] * noise
        psi_prop = self.wf(self.phys_conf(R, r_prop))
        accepted = 2 * (psi_prop.log - state['psi'].log) > torch.log(uniforms)
        acceptance = accepted.to(state['r'].dtype).mean()

        def pick(new, old):
            return torch.where(accepted.view(-1, *(1,) * (new.dim() - 1)), new, old)

        state = {
            'r': pick(r_prop, state['r']),
            'psi': Psi(*(pick(n, o) for n, o in zip(psi_prop, state['psi']))),
            'age': pick(torch.zeros_like(state['age']), state['age'] + 1),
            'tau': state['tau'] * (torch.clamp(acceptance, min=0.05) / self.TARGET_ACCEPTANCE),
        }
        stats = {'sampling/acceptance': acceptance, **self._stats(state)}
        return state, self.phys_conf(R, state['r']), stats

    def sample(self, gen: torch.Generator, state: dict, R):
        r = state['r']
        noise = torch.randn(r.shape, generator=gen, dtype=r.dtype, device=r.device)
        uniforms = torch.rand(r.shape[0], generator=gen, dtype=r.dtype, device=r.device)
        return self.step(state, R, noise, uniforms)

    @staticmethod
    def _stats(state) -> dict:
        return {
            'sampling/tau': state['tau'],
            'sampling/age/mean': state['age'].to(state['r'].dtype).mean(),
            'sampling/age/max': state['age'].max(),
            'sampling/log_psi/mean': state['psi'].log.mean(),
            'sampling/log_psi/std': state['psi'].log.std(correction=0),
            'sampling/dists/mean': pairwise_self_distance(state['r']).mean(),
        }


class DecorrSampler:
    """``length`` MCMC moves per sample call; the stats are the last move's."""

    def __init__(self, *, length: int):
        self.length = length

    def wrap(self, inner):
        return _Decorr(inner, self.length)


class _Decorr:
    def __init__(self, inner, length):
        self.inner, self.length = inner, length

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def sample(self, gen, state, R):
        for _ in range(self.length):
            state, phys_conf, stats = self.inner.sample(gen, state, R)
        return state, phys_conf, stats
