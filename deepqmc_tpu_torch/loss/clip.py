"""Robust clipping of the local energies before they enter the VMC gradient
(counterpart of ``deepqmc_tpu/loss/clip.py``, one molecule and one state).

Each function takes the local energies of one electron batch ``[B]`` and
returns ``(clipped, gradient_mask)``: the energies recentred on a robust
location and compressed (or cut) at a scale taken from the batch, and a mask
that drops from the gradient each walker whose residual exceeds
``exclude_width`` scales (off by default).  ``psi_ratio_clip_and_mask`` does the
same for the wave-function ratios of the overlap penalty, one ``(i, j)`` pair
of states at a time (:func:`clip_psi_ratio`).
"""

import math

import torch

from ..parallel import all_device_mean, all_device_median, all_device_quantile
from ..utils import log_squeeze

__all__ = [
    'clip_local_energy', 'clip_psi_ratio', 'median_clip_and_mask', 'median_log_squeeze_and_mask',
    'psi_ratio_clip_and_mask',
]


def _recentre(x: torch.Tensor, robust: bool):
    """(centre, residuals, |residuals|) around the median (``robust``) or the mean."""
    loc = (all_device_median if robust else all_device_mean)(x)
    resid = x - loc
    return loc, resid, resid.abs()


def _hard_window(loc, resid, absr, window, exclude_width):
    """Residuals clamped into ``loc +/- window``; the mask keeps ``absr < exclude_width``."""
    return loc + torch.clamp(resid, -window, window), absr < exclude_width


def median_clip_and_mask(
    x: torch.Tensor, clip_width: float, median_center: bool, exclude_width: float = math.inf,
):
    """Hard clip at ``clip_width`` mean absolute deviations around the median
    (``median_center``) or the mean: the FermiNet/PsiFormer recipe."""
    loc, resid, absr = _recentre(x, robust=median_center)
    return _hard_window(loc, resid, absr, clip_width * all_device_mean(absr), exclude_width)


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


def psi_ratio_clip_and_mask(psi_ratio: torch.Tensor, *, clip_width: float = 10.0,
                            exclude_width: float = math.inf):
    """Hard clip of the ratios of two states' wave functions at ``clip_width``
    median absolute deviations around the median: ratios have heavier tails
    than local energies, so the scale is a median too."""
    loc, resid, absr = _recentre(psi_ratio, robust=True)
    return _hard_window(loc, resid, absr, clip_width * all_device_median(absr), exclude_width)


def _clip_rows(clip_mask_fn, x: torch.Tensor):
    """``clip_mask_fn`` on each walker batch (last axis) of the grid ``x``."""
    out = [clip_mask_fn(row) for row in x.flatten(0, -2)]
    return (torch.stack([c for c, _ in out]).view_as(x),
            torch.stack([m for _, m in out]).view(x.shape))


def clip_local_energy(clip_mask_fn, local_energy: torch.Tensor):
    """The clip function per (molecule, state) batch of a ``[mol, state, walker]`` grid."""
    return _clip_rows(clip_mask_fn, local_energy)


def clip_psi_ratio(clip_mask_fn, psi_ratio: torch.Tensor):
    """The clip function per (molecule, state, state) batch of the ratios."""
    return _clip_rows(clip_mask_fn, psi_ratio)
