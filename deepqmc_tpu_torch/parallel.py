"""Reductions over the walker batch (counterpart of the single-process
``all_device_*`` helpers and ``pexp_normalize_mean`` of
``deepqmc_tpu/parallel.py``).

The JAX package computes these over the globally sharded walker axis; here the
batch lives on one device, so each is the plain reduction over all of it.  ``jnp.median`` and
``jnp.quantile`` interpolate linearly between the two nearest order
statistics; ``torch.median`` returns the lower of the two middle values of an
even batch, so the median here is ``torch.quantile(x, 0.5)`` with linear
interpolation, as the quantile is.
"""

import torch

__all__ = ['all_device_mean', 'all_device_median', 'all_device_quantile', 'pexp_normalize_mean']


def all_device_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean()


def all_device_quantile(x: torch.Tensor, q) -> torch.Tensor:
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return torch.quantile(x, q, interpolation='linear')


def all_device_median(x: torch.Tensor) -> torch.Tensor:
    return all_device_quantile(x, 0.5)


def pexp_normalize_mean(log_w: torch.Tensor, dim=None) -> torch.Tensor:
    """``exp(log_w)`` normalised to unit mean (over ``dim``, or all of it),
    computed after shifting by the maximum."""
    if dim is None:
        w = torch.exp(log_w - log_w.max())
        return w / w.mean()
    w = torch.exp(log_w - log_w.amax(dim, keepdim=True))
    return w / w.mean(dim, keepdim=True)
