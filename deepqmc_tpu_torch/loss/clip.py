"""Robust clipping of the local energies before they enter the VMC gradient
(counterpart of ``deepqmc_tpu/loss/clip.py``, one molecule and one state).

Each function takes the local energies of one electron batch ``[B]`` and
returns ``(clipped, gradient_mask)``: the energies recentred on a robust
location and compressed (or cut) at a scale taken from the batch, and a mask
that drops from the gradient each walker whose residual exceeds
``exclude_width`` scales (off by default).  ``psi_ratio_clip_and_mask`` waits
for excited states.
"""

import math

import torch

from ..parallel import all_device_mean, all_device_median, all_device_quantile
from ..utils import log_squeeze

__all__ = ['median_clip_and_mask', 'median_log_squeeze_and_mask']


def _recentre(x: torch.Tensor, robust: bool):
    """(centre, residuals, |residuals|) around the median (``robust``) or the mean."""
    loc = (all_device_median if robust else all_device_mean)(x)
    resid = x - loc
    return loc, resid, resid.abs()


def median_clip_and_mask(
    x: torch.Tensor, clip_width: float, median_center: bool, exclude_width: float = math.inf,
):
    """Hard clip at ``clip_width`` mean absolute deviations around the median
    (``median_center``) or the mean: the FermiNet/PsiFormer recipe."""
    loc, resid, absr = _recentre(x, robust=median_center)
    window = clip_width * all_device_mean(absr)
    return loc + torch.clamp(resid, -window, window), absr < exclude_width


def median_log_squeeze_and_mask(
    x: torch.Tensor, clip_width: float = 1.0, quantile: float = 0.95,
    exclude_width: float = math.inf,
):
    """Soft clip: residuals around the median pass unchanged near 0 and are
    squeezed logarithmically beyond ``2 * clip_width`` scales, the scale being
    the ``quantile``-th quantile of |residual|; no walker is dropped unless
    ``exclude_width`` is finite."""
    _, resid, absr = _recentre(x, robust=True)
    scale = all_device_quantile(absr, quantile)
    halfwidth = 2 * clip_width * scale
    squeezed = halfwidth * log_squeeze(resid / halfwidth)
    return x + (squeezed - resid), absr / scale < exclude_width
