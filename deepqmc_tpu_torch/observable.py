"""Observable monitors evaluated during training and evaluation (counterpart
of ``deepqmc_tpu/observable.py``).

Every monitor is a :class:`MonitorSpec`, a batch-level sample function plus an
optional stats reducer, run by :class:`ObservableMonitor` every ``period``
steps on the last step of a block.  The default monitors, of the local energy
and of the wave function, are computed inside the step itself
(``fit.fit_wf``); the others (spin, forces, psi ratios, positions, oscillator
strengths) are not ported yet and raise: they come with excited states and
forces (ROADMAP.md, queue 1 item 7).
"""

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from .types import PhysicalConfiguration, Psi

__all__ = [
    'Batch', 'EnergyMonitor', 'MonitorSpec', 'ObservableMonitor', 'WaveFunctionMonitor',
    'default_observable_monitors',
]


@dataclass(frozen=True)
class Batch:
    """Everything a monitor may look at after one optimization step; the
    arrays have the grid ``[mol, state, walker]`` in front."""

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


def _not_ported(name: str):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f'{name} is not ported yet; it comes with excited states and forces '
            '(ROADMAP.md, queue 1 item 7)'
        )

    return type(name, (ObservableMonitor,), {'__init__': __init__})


SpinMonitor = _not_ported('SpinMonitor')
ForceMonitor = _not_ported('ForceMonitor')
BareForceMonitor = _not_ported('BareForceMonitor')
ACZVForceMonitor = _not_ported('ACZVForceMonitor')
ACZVZBForceMonitor = _not_ported('ACZVZBForceMonitor')
ACZVQForceMonitor = _not_ported('ACZVQForceMonitor')
ACZVZBQForceMonitor = _not_ported('ACZVZBQForceMonitor')
PsiRatioMonitor = _not_ported('PsiRatioMonitor')
ElectronPositionMonitor = _not_ported('ElectronPositionMonitor')
NuclearPositionMonitor = _not_ported('NuclearPositionMonitor')
OscillatorStrengthMonitor = _not_ported('OscillatorStrengthMonitor')


def default_observable_monitors() -> list[ObservableMonitor]:
    """Energy and wave-function monitors, evaluated every step."""
    return [
        EnergyMonitor(save_samples=True, period=1),
        WaveFunctionMonitor(save_samples=True, period=1),
    ]
