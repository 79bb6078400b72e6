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
The force and position monitors are not ported yet and raise (ROADMAP.md,
queue 1 item 7).
"""

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from .physics import evaluate_spin
from .types import PhysicalConfiguration, Psi
from .wf.base import wf_states

__all__ = [
    'Batch', 'EnergyMonitor', 'MonitorSpec', 'ObservableMonitor', 'OscillatorStrengthMonitor',
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
    return {'local_energy/mean': e.mean(-1), 'local_energy/std': e.std(-1, correction=0),
            'local_energy/min': e.amin(-1), 'local_energy/max': e.amax(-1)}


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
    return {f'{name}/mean': samples.mean(2), f'{name}/std': samples.std(2, correction=0)}


class SpinMonitor(ObservableMonitor):
    """The local S^2 of every walker under its state's module (``physics.evaluate_spin``)."""

    name = 'spin'

    def spec(self, hamil, wf) -> MonitorSpec:
        states = wf_states(wf)

        def sample(batch: Batch):
            pc = batch.phys_conf
            return torch.stack([
                torch.stack([
                    evaluate_spin(hamil, states[s], PhysicalConfiguration(R, r[s], i[s]))
                    for s in range(len(states))
                ]) for R, r, i in zip(pc.R, pc.r, pc.mol_idx)
            ])

        return MonitorSpec('spin', sample, lambda b, x: walker_moments('spin', x))


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
    n = batch.local_energy.shape[-1]

    def mean_err(x, dim):
        return x.mean(dim), x.std(dim, correction=0) / n**0.5

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


def _not_ported(name: str):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f'{name} is not ported yet; it comes with forces and the position monitors '
            '(ROADMAP.md, queue 1 item 7)'
        )

    return type(name, (ObservableMonitor,), {'__init__': __init__})


ForceMonitor = _not_ported('ForceMonitor')
BareForceMonitor = _not_ported('BareForceMonitor')
ACZVForceMonitor = _not_ported('ACZVForceMonitor')
ACZVZBForceMonitor = _not_ported('ACZVZBForceMonitor')
ACZVQForceMonitor = _not_ported('ACZVQForceMonitor')
ACZVZBQForceMonitor = _not_ported('ACZVZBQForceMonitor')
ElectronPositionMonitor = _not_ported('ElectronPositionMonitor')
NuclearPositionMonitor = _not_ported('NuclearPositionMonitor')


def default_observable_monitors() -> list[ObservableMonitor]:
    """Energy and wave-function monitors, evaluated every step."""
    return [
        EnergyMonitor(save_samples=True, period=1),
        WaveFunctionMonitor(save_samples=True, period=1),
    ]
