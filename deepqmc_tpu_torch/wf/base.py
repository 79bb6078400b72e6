"""One wave-function module per electronic state (counterpart of
``init_wf_params`` and ``merge_states`` of ``deepqmc_tpu/wf/base.py`` and
``deepqmc_tpu/optimizer.py``).

The JAX package stacks every parameter on a leading state axis and ``vmap``s
over it.  The port's kernels are ``ctypes`` launches that cannot be vmapped,
so here each state is a module of its own in a :class:`StateStack`, drawn
from its own generator, and every state loop is a Python loop.  A plain
module is the one-state case (:func:`wf_states`).
"""

from typing import Optional

import torch

from ..nn import jax_param_paths

__all__ = ['StateStack', 'init_wf_states', 'merge_states', 'wf_states']


class StateStack(torch.nn.ModuleList):
    """The modules of the electronic states, state ``s`` at index ``s``."""


def wf_states(wf) -> list:
    """The state modules of ``wf``: the modules of a :class:`StateStack`, or ``[wf]``."""
    return list(wf) if isinstance(wf, StateStack) else [wf]


def init_wf_states(make, gens, merge_keys: Optional[list[str]] = None) -> StateStack:
    """A :class:`StateStack` of ``make(gen=gen)`` per generator of ``gens``
    (one per state), the ``merge_keys`` bundles averaged over the states."""
    stack = StateStack([make(gen=gen) for gen in gens])
    merge_states(stack, merge_keys)
    return stack


def merged_keys(wf, merge_keys: Optional[list[str]]) -> list[str]:
    """The ``state_dict`` keys of one state whose JAX module path contains one
    of ``merge_keys`` (``deepqmc_tpu.utils.filter_dict`` on the top-level bundles)."""
    if not merge_keys:
        return []
    paths = jax_param_paths(wf_states(wf)[0])
    return [k for k, (path, _) in paths.items() if any(key in path for key in merge_keys)]


@torch.no_grad()
def merge_states(wf, merge_keys: Optional[list[str]]):
    """Average the parameters of ``merged_keys`` over the states of ``wf`` in
    place, so that each is bitwise equal across the states."""
    states = wf_states(wf)
    if len(states) == 1:
        return
    params = [dict(s.named_parameters()) for s in states]
    for key in merged_keys(wf, merge_keys):
        mean = torch.stack([p[key] for p in params]).mean(0)
        for p in params:
            p[key].copy_(mean)
