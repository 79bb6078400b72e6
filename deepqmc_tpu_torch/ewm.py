"""Adaptive exponentially-weighted-mean energy estimator (counterpart of
``deepqmc_tpu/ewm.py``, one molecule and one state): normalised weights
``alpha_i * prod_{j<i} (1 - alpha_j)`` over a ring buffer of recent values."""

from math import ceil
from typing import NamedTuple, Optional

import torch

__all__ = ['EWMState', 'init_ewm']


class EWMState(NamedTuple):
    step: int
    alpha: torch.Tensor
    buffer: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    sqerr: torch.Tensor


MAX_ALPHA, DECAY_ALPHA = 0.999, 10.0


def init_ewm(window_size: Optional[int] = None, *, dtype=torch.float64, device=None):
    """Create an EWM state and its pure update function ``(x, state) -> state``."""
    max_alpha, decay_alpha = MAX_ALPHA, DECAY_ALPHA
    if window_size is None:
        window_size = ceil(decay_alpha * (1 / (1 - max_alpha) - 2))
    nan = torch.tensor(float('nan'), dtype=dtype, device=device)
    state = EWMState(
        step=0,
        alpha=torch.zeros(window_size, dtype=dtype, device=device),
        buffer=torch.zeros(window_size, dtype=dtype, device=device),
        mean=nan, var=nan, sqerr=nan,
    )

    def update(x, state: EWMState) -> EWMState:
        x = torch.as_tensor(x, dtype=dtype, device=state.buffer.device)
        buffer = torch.cat([x[None], state.buffer[:-1]])
        head = max(1 - max_alpha, 1 / (2 + state.step / decay_alpha))
        shifted = torch.cat([state.alpha.new_full((1,), head), state.alpha[:-1]])
        # once the window is full the alphas stay frozen
        alpha = state.alpha if state.step + 1 >= window_size else shifted
        beta = torch.cat([alpha.new_ones(1), torch.cumprod(1 - alpha[:-1], 0)])
        weights = alpha * beta
        weights = weights / torch.clamp(weights.sum(), min=torch.finfo(dtype).tiny)
        mean = (weights * buffer).sum()
        var_terms = weights * (buffer - mean) ** 2
        return EWMState(
            step=state.step + 1, alpha=alpha, buffer=buffer, mean=mean,
            var=var_terms.sum(), sqerr=(weights * var_terms).sum(),
        )

    return state, update
