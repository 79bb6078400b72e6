"""Adaptive exponentially-weighted-mean energy estimator (counterpart of
``deepqmc_tpu/ewm.py``): normalised weights ``alpha_i * prod_{j<i} (1 - alpha_j)``
over a ring buffer of recent values, for one value (:func:`init_ewm`) or a
grid of them over (molecule, electronic state) updated by subset
(:func:`init_multi_mol_multi_state_ewm`)."""

from math import ceil
from typing import NamedTuple, Optional

import torch

from .utils import set_rows

__all__ = ['EWMState', 'init_ewm', 'init_multi_mol_multi_state_ewm']


class EWMState(NamedTuple):
    """Each field has the grid's shape in front; ``alpha`` and ``buffer`` add the window."""

    step: torch.Tensor
    alpha: torch.Tensor
    buffer: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    sqerr: torch.Tensor


MAX_ALPHA, DECAY_ALPHA = 0.999, 10.0


def _init(shape, window_size, dtype, device, decay_alpha=DECAY_ALPHA):
    if window_size is None:
        window_size = ceil(decay_alpha * (1 / (1 - MAX_ALPHA) - 2))
    nan = torch.full(shape, float('nan'), dtype=dtype, device=device)
    state = EWMState(
        step=torch.zeros(shape, dtype=torch.long, device=device),
        alpha=torch.zeros(*shape, window_size, dtype=dtype, device=device),
        buffer=torch.zeros(*shape, window_size, dtype=dtype, device=device),
        mean=nan, var=nan, sqerr=nan,
    )

    def update(x, state: EWMState) -> EWMState:
        """The EWMs of the grid ``state`` after the values ``x`` (of its shape)."""
        dtype = state.buffer.dtype
        x = torch.as_tensor(x, dtype=dtype, device=state.buffer.device)
        buffer = torch.cat([x[..., None], state.buffer[..., :-1]], -1)
        head = torch.clamp(1 / (2 + state.step.to(dtype) / decay_alpha), min=1 - MAX_ALPHA)
        shifted = torch.cat([head[..., None], state.alpha[..., :-1]], -1)
        # once the window is full the alphas stay frozen
        frozen = (state.step + 1 >= window_size)[..., None]
        alpha = torch.where(frozen, state.alpha, shifted)
        beta = torch.cat([torch.ones_like(alpha[..., :1]), torch.cumprod(1 - alpha[..., :-1], -1)],
                         -1)
        weights = alpha * beta
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=torch.finfo(dtype).tiny)
        mean = (weights * buffer).sum(-1)
        var_terms = weights * (buffer - mean[..., None]) ** 2
        return EWMState(
            step=state.step + 1, alpha=alpha, buffer=buffer, mean=mean,
            var=var_terms.sum(-1), sqerr=(weights * var_terms).sum(-1),
        )

    return state, update


def init_ewm(window_size: Optional[int] = None, *, dtype=torch.float64, device=None,
             decay_alpha: float = DECAY_ALPHA):
    """An EWM state of one value and its pure update function ``(x, state) -> state``."""
    return _init((), window_size, dtype, device, decay_alpha)


def init_multi_mol_multi_state_ewm(shape: tuple, window_size: Optional[int] = None, *,
                                   dtype=torch.float64, device=None,
                                   decay_alpha: float = DECAY_ALPHA):
    """An EWM grid of ``shape`` (molecules, states) and its update function
    ``(x, state, sub_idxs=None) -> state``: ``x`` has the grid's shape, or with
    ``sub_idxs`` (molecule indices, a CPU tensor) that of the rows it names,
    which alone change."""
    state, update = _init(tuple(shape), window_size, dtype, device, decay_alpha)

    def multi_update(x, state: EWMState, sub_idxs=None) -> EWMState:
        if sub_idxs is None:
            return update(x, state)
        idxs = sub_idxs.tolist()
        new = update(x, EWMState(*(torch.stack([leaf[i] for i in idxs]) for leaf in state)))
        return EWMState(*(set_rows(leaf, idxs, rows) for leaf, rows in zip(state, new)))

    return state, multi_update
