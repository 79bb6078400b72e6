"""Edge featurisations (counterpart of ``deepqmc_tpu/gnn/edge_features.py``).

Each feature maps difference vectors ``[..., 3]`` (tensor or FL) to
``[..., len(feature)]``.
"""

from collections.abc import Sequence
from typing import Optional

import numpy as np
import torch

from .. import fwdlap as fl
from ..physics import norm_safe

__all__ = ['CombinedEdgeFeature', 'DifferenceEdgeFeature', 'DistancePowerEdgeFeature',
           'GaussianEdgeFeature']


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
    """Powers of the edge length, a power p <= 0 as ``1 / (r^-p + eps)``,
    optionally log-damped."""

    def __init__(self, *, powers: Sequence[float], eps: Optional[float] = None,
                 log_rescale: bool = False):
        if any(p < 0 for p in powers) and eps is None:
            raise ValueError('negative powers need an eps regularizer')
        self.powers = list(powers)
        self.eps = eps or 0.0
        self.log_rescale = log_rescale

    def __call__(self, d):
        r = norm_safe(d)
        rk = r[..., None]
        powered = fl.cat([rk**p if p > 0 else 1 / (rk ** (-p) + self.eps) for p in self.powers],
                         -1)
        return _log_damp(powered, r) if self.log_rescale else powered

    def __len__(self):
        return len(self.powers)


class GaussianEdgeFeature:
    """The edge length in a basis of Gaussians whose centres crowd towards 0
    (quadratically spaced up to ``radius``)."""

    def __init__(self, *, n_gaussian: int, radius: float, offset: bool):
        pad = 1 / (2 * n_gaussian) if offset else 0
        knots = np.linspace(pad, 1 - pad, n_gaussian)
        self.mus = radius * knots**2
        self.sigmas = (1 + radius * knots) / 7

    def __call__(self, d):
        r = norm_safe(d)
        x = fl.primal(r)
        mus, sigmas = (torch.as_tensor(a, dtype=x.dtype, device=x.device)
                       for a in (self.mus, self.sigmas))
        diff = r[..., None] - mus
        return fl.exp(-(diff * diff) / sigmas**2)

    def __len__(self):
        return len(self.mus)


class CombinedEdgeFeature:
    """Concatenation of several edge features."""

    def __init__(self, *, features: list):
        self.features = features

    def __call__(self, d):
        return fl.cat([f(d) for f in self.features], -1)

    def __len__(self):
        return sum(map(len, self.features))
