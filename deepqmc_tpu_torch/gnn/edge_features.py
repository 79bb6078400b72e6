"""Edge featurisations (counterpart of ``deepqmc_tpu/gnn/edge_features.py``).

Each feature maps difference vectors ``[..., 3]`` (tensor or FL) to
``[..., len(feature)]``.
"""

from collections.abc import Sequence

from .. import fwdlap as fl
from ..physics import norm_safe

__all__ = ['CombinedEdgeFeature', 'DifferenceEdgeFeature', 'DistancePowerEdgeFeature']


def _log_damp(features, r):
    """Rescale per-edge features by log(1+r)/r (tames the long-range tail)."""
    return features * (fl.log1p(r) / r)[..., None]


class DifferenceEdgeFeature:
    """The raw difference vector, optionally log-damped."""

    def __init__(self, *, log_rescale: bool = False):
        self.log_rescale = log_rescale

    def __call__(self, d):
        return _log_damp(d, norm_safe(d)) if self.log_rescale else d

    def __len__(self):
        return 3


class DistancePowerEdgeFeature:
    """Positive powers of the edge length, optionally log-damped."""

    def __init__(self, *, powers: Sequence[float], log_rescale: bool = False):
        if any(p <= 0 for p in powers):
            raise ValueError('the port supports positive distance powers only')
        self.powers = list(powers)
        self.log_rescale = log_rescale

    def __call__(self, d):
        r = norm_safe(d)
        rk = r[..., None]
        powered = fl.cat([rk**p for p in self.powers], -1)
        return _log_damp(powered, r) if self.log_rescale else powered

    def __len__(self):
        return len(self.powers)


class CombinedEdgeFeature:
    """Concatenation of several edge features."""

    def __init__(self, *, features: list):
        self.features = features

    def __call__(self, d):
        return fl.cat([f(d) for f in self.features], -1)

    def __len__(self):
        return sum(map(len, self.features))
