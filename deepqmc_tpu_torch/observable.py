"""Observable monitors evaluated during training and evaluation (counterpart
of ``deepqmc_tpu/observable.py``).

Every monitor is a :class:`MonitorSpec`, a batch-level sample function plus an
optional stats reducer, run by :class:`ObservableMonitor` every ``period``
steps on the last step of a block.  The default monitors, of the local energy
and of the wave function, are computed inside the step itself
(``fit.fit_wf``).  Those of excited states: the local S^2 of each state's
walkers (:class:`SpinMonitor`, one batched forward of the spin swaps per
state), the loss's wave-function ratios (:class:`PsiRatioMonitor`) and the
oscillator strengths between states (:class:`OscillatorStrengthMonitor`).
The Hellmann-Feynman forces of each walker under its state's module
(:class:`ForceMonitor` and its five aliases, the estimators of
:mod:`.force`) and the electron and nuclear positions
(:class:`ElectronPositionMonitor`, :class:`NuclearPositionMonitor`).

The statistics are per (molecule, state) over the global walker axis: with
walkers sharded over processes each rank's samples are its own walkers'.
"""

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

import torch

from .parallel import (
    all_device_max,
    all_device_mean,
    all_device_min,
    all_device_std,
    get_process_count,
)
from .physics import evaluate_spin
from .types import PhysicalConfiguration, Psi
from .wf.base import wf_states

__all__ = [
    'ACZVForceMonitor', 'ACZVQForceMonitor', 'ACZVZBForceMonitor', 'ACZVZBQForceMonitor',
    'Batch', 'BareForceMonitor', 'ElectronPositionMonitor', 'EnergyMonitor', 'ForceMonitor',
    'MonitorSpec', 'NuclearPositionMonitor', 'ObservableMonitor', 'OscillatorStrengthMonitor',
    'PsiRatioMonitor', 'SpinMonitor', 'WaveFunctionMonitor', 'default_observable_monitors',
    'oscillator_strength_statistics',
]


@dataclass(frozen=True)
class Batch:
    """Everything a monitor may look at after one optimization step; the
    arrays have the grid ``[mol, state, walker]`` in front (``psi_ratios``
    ``[mol, state, state, walker]``, None for one state)."""

    params: Any
    phys_conf: PhysicalConfiguration
    psi: Psi
    local_energy: torch.Tensor
    psi_ratios: Optional[torch.Tensor]


@dataclass(frozen=True)
class MonitorSpec:
    """A named observable: batch-level sampler + optional stats reducer."""

    name: str
    sample: Callable[[Batch], Any]
    stats: Optional[Callable[[Batch, Any], dict]] = None


class ObservableMonitor:
    """Periodic runner of one :class:`MonitorSpec`; subclasses provide :meth:`spec`."""

    name: str

    def __init__(self, save_samples: bool, period: int):
        assert period > 0
        self.save_samples = save_samples
        self.period = period
        self._spec: Optional[MonitorSpec] = None

    def spec(self, hamil, wf) -> MonitorSpec:
        raise NotImplementedError

    def finalize(self, hamil, wf) -> 'ObservableMonitor':
        self._spec = self.spec(hamil, wf)
        return self

    def __call__(self, step: int, params, phys_conf, psi, local_energy, psi_ratios) -> dict:
        if step % self.period:
            return {}
        spec = self._spec
        assert spec is not None, 'call ObservableMonitor.finalize first'
        batch = Batch(params, phys_conf, psi, local_energy, psi_ratios)
        with torch.no_grad():
            samples = spec.sample(batch)
            stats = spec.stats(batch, samples) if spec.stats else {}
        if self.save_samples and samples is not None:
            stats |= {f'{spec.name}/samples': samples}
        return stats


def energy_statistics(batch: Batch, samples) -> dict:
    """Walker statistics of the local energies."""
    e = batch.local_energy
    return {'local_energy/mean': all_device_mean(e, -1), 'local_energy/std': all_device_std(e, -1),
            'local_energy/min': all_device_min(e, -1), 'local_energy/max': all_device_max(e, -1)}


class EnergyMonitor(ObservableMonitor):
    """Walker statistics (and samples) of the local energies."""

    name = 'local_energy'

    def spec(self, hamil, wf) -> MonitorSpec:
        return MonitorSpec('local_energy', lambda b: b.local_energy, energy_statistics)


class WaveFunctionMonitor(ObservableMonitor):
    """Record the wave function sign/log at the sampled configurations."""

    name = 'psi'

    def spec(self, hamil, wf) -> MonitorSpec:
        return MonitorSpec('psi', lambda b: {'sign': b.psi.sign, 'log': b.psi.log})


def walker_moments(name: str, samples: torch.Tensor) -> dict:
    """Per-(mol, state) mean and (population) spread over the walkers."""
    return {f'{name}/mean': all_device_mean(samples, 2),
            f'{name}/std': all_device_std(samples, 2)}


def _per_walker_spec(name: str, fn_factory, with_energy: bool = False):
    """``spec`` of an observable of one molecule's walkers of one state:
    ``fn_factory(hamil, state_module)`` gives ``fn(phys_conf)`` (with
    ``with_energy``, ``fn(phys_conf, E_loc, E_mean)``, the mean over the
    walkers of that molecule and state) of shape ``[B, ...]``.  It runs over
    the ``[mol, state, walker]`` grid, each state's walkers with that state's
    module (the JAX package's ``grid_vmap``); its stats are the walker mean
    and spread."""

    def build(self, hamil, wf) -> MonitorSpec:
        fns = [fn_factory(hamil, state) for state in wf_states(wf)]

        def sample(batch: Batch):
            pc, e = batch.phys_conf, batch.local_energy
            return torch.stack([
                torch.stack([
                    fn(PhysicalConfiguration(R, r[s], i[s]),
                       *((e_m[s], all_device_mean(e_m[s]).expand_as(e_m[s])) if with_energy
                         else ()))
                    for s, fn in enumerate(fns)
                ]) for R, r, i, e_m in zip(pc.R, pc.r, pc.mol_idx, e)
            ])

        return MonitorSpec(name, sample, lambda b, x: walker_moments(name, x))

    return build


class SpinMonitor(ObservableMonitor):
    """The local S^2 of every walker under its state's module (``physics.evaluate_spin``)."""

    name = 'spin'
    spec = _per_walker_spec('spin', lambda hamil, wf: partial(evaluate_spin, hamil, wf))


class PsiRatioMonitor(ObservableMonitor):
    """The loss's ratios ``psi_i / psi_j`` at the walkers of state j."""

    name = 'psi_ratio'

    def spec(self, hamil, wf) -> MonitorSpec:
        def sample(batch: Batch):
            if batch.psi_ratios is None:
                raise ValueError('PsiRatioMonitor needs more than one electronic state')
            return batch.psi_ratios

        return MonitorSpec('psi_ratio', sample)


def oscillator_strength_statistics(batch: Batch, samples) -> dict:
    """Oscillator strengths f_ij = 2/3 (E_j - E_i) |<i|r|j>|^2 between the
    states, the transition dipoles estimated from the wave-function ratios,
    and their errors propagated to first order (the algebra of
    ``deepqmc_tpu/observable.py``: the zero-gap diagonal gets zero error, not NaN)."""
    if batch.psi_ratios is None:
        raise ValueError('OscillatorStrengthMonitor needs more than one electronic state')
    n = batch.local_energy.shape[-1] * get_process_count()

    def mean_err(x, dim):
        return all_device_mean(x, dim), all_device_std(x, dim) / n**0.5

    e, e_err = mean_err(batch.local_energy, -1)
    gap = e[..., None, :] - e[..., :, None]  # gap[mol, i, j] = E_j - E_i
    gap_err = (e_err[..., None, :] ** 2 + e_err[..., :, None] ** 2) ** 0.5
    # transition dipole components (-sum_k r_k) psi_i / psi_j at the walkers of j
    dipole = (-batch.phys_conf.r).sum(-2)[:, None] * batch.psi_ratios[..., None]
    d, d_err = mean_err(dipole, -2)
    d_rel = d_err / d
    strength_vec = d * d.transpose(1, 2)
    strength_vec_err = strength_vec.abs() * (d_rel**2 + d_rel.transpose(1, 2) ** 2) ** 0.5
    strength = strength_vec.sum(-1)
    strength_err = (strength_vec_err**2).sum(-1) ** 0.5
    f = (2 / 3) * gap * strength

    def safe(num, den):
        return torch.where(den != 0, num / torch.where(den == 0, torch.ones_like(den), den),
                           torch.zeros_like(num))

    f_err = f.abs() * (safe(gap_err, gap) ** 2 + safe(strength_err, strength) ** 2) ** 0.5
    return {'oscillator_strength/mean': f, 'oscillator_strength/err': f_err}


class OscillatorStrengthMonitor(ObservableMonitor):
    """The oscillator strengths between the states and their errors (stats only)."""

    name = 'oscillator_strength'

    def spec(self, hamil, wf) -> MonitorSpec:
        return MonitorSpec('oscillator_strength', lambda b: None, oscillator_strength_statistics)


class ForceMonitor(ObservableMonitor):
    """Hellmann-Feynman force estimator monitor, one of the five of
    :mod:`.force`: the bare Coulomb estimator, the antithetic-coordinate
    zero-variance ('ac_zv'), its zero-bias extension ('ac_zvzb', which reads
    the local energies), and their Q-function counterparts.  Samples
    ``[mol, state, walker, n_nuc, 3]``."""

    KINDS = {
        'bare': ('evaluate_hf_force_bare', False),
        'ac_zv': ('evaluate_hf_force_ac_zv', False),
        'ac_zvzb': ('evaluate_hf_force_ac_zvzb', True),
        'ac_zvq': ('evaluate_hf_force_ac_zvq', False),
        'ac_zvzbq': ('evaluate_hf_force_ac_zvzbq', True),
    }

    def __init__(self, kind: str, save_samples: bool, period: int):
        super().__init__(save_samples, period)
        if kind not in self.KINDS:
            raise ValueError(f'unknown force estimator {kind!r} (one of {sorted(self.KINDS)})')
        self.kind = kind
        self.name = f'hf_force_{kind}'

    def spec(self, hamil, wf) -> MonitorSpec:
        from . import force

        builder_name, with_energy = self.KINDS[self.kind]
        builder = getattr(force, builder_name)
        factory = (lambda h, w: builder(h)) if self.kind == 'bare' else builder
        return _per_walker_spec(self.name, factory, with_energy)(self, hamil, wf)


# the config's constructor names (deepqmc_tpu/observable.py:230-236)
BareForceMonitor = partial(ForceMonitor, 'bare')
ACZVForceMonitor = partial(ForceMonitor, 'ac_zv')
ACZVZBForceMonitor = partial(ForceMonitor, 'ac_zvzb')
ACZVQForceMonitor = partial(ForceMonitor, 'ac_zvq')
ACZVZBQForceMonitor = partial(ForceMonitor, 'ac_zvzbq')


class ElectronPositionMonitor(ObservableMonitor):
    """The electron positions ``[mol, state, walker, n_elec, 3]`` (samples only)."""

    name = 'r'

    def spec(self, hamil, wf) -> MonitorSpec:
        return MonitorSpec('r', lambda b: b.phys_conf.r)


class NuclearPositionMonitor(ObservableMonitor):
    """The nuclear positions of each (molecule, state), ``[mol, state, n_nuc, 3]``
    (samples only)."""

    name = 'R'

    def spec(self, hamil, wf) -> MonitorSpec:
        def sample(batch: Batch):
            R, r = batch.phys_conf.R, batch.phys_conf.r
            return R[:, None].expand(R.shape[0], r.shape[1], *R.shape[1:])

        return MonitorSpec('R', sample)


def default_observable_monitors() -> list[ObservableMonitor]:
    """Energy and wave-function monitors, evaluated every step."""
    return [
        EnergyMonitor(save_samples=True, period=1),
        WaveFunctionMonitor(save_samples=True, period=1),
    ]
