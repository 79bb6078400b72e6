"""JAX parameters -> the port's ``state_dict``; JAX KFAC state -> the port's.

The JAX package keeps parameters as ``{module/path: {name: array}}``; the port
records each parameter's JAX address (``nn.core.jax_param_paths``), so the
conversion is a lookup, with no table of paths: the port's modules name
themselves as the JAX package's do, so every path of the ansatz zoo (the
per-type ``u{type}``, ``g_nuc``, the per-channel ``g_{name}``, the nuclear
``embeddings``, the head's readouts and biases, the envelopes and cusps)
maps as it is.  Weights share the JAX layout (``[in, out]``), and so
do the KFAC factors and inverses, which both packages key by the layer's path.
Several electronic states: JAX stacks every parameter on a leading state
axis, and keeps one KFAC factor and inverse dict per state in a list; the
port has one module per state (:class:`~.wf.StateStack`) and the same lists.
"""

import numpy as np
import torch

from .nn import jax_param_paths
from .wf.base import wf_states

__all__ = ['kfac_state_from_jax', 'state_dict_from_jax']


def state_dict_from_jax(params, module: torch.nn.Module, dtype=torch.float64) -> dict:
    """A ``state_dict`` for ``module`` from a JAX parameter dict of numpy-convertible
    arrays; raises if a parameter is missing on either side or has another shape.
    For a :class:`~.wf.StateStack` of S > 1 states the JAX parameters are
    stacked, each with a leading state axis of S."""
    states = wf_states(module)
    if len(states) > 1:
        out = {}
        for s, state in enumerate(states):
            one = {p: {n: np.asarray(v)[s] for n, v in bundle.items()} for p, bundle in params.items()}
            out |= {f'{s}.{k}': v for k, v in _state_dict_from_jax(one, state, dtype).items()}
        return out
    return _state_dict_from_jax(params, states[0], dtype)


def _state_dict_from_jax(params, module: torch.nn.Module, dtype) -> dict:
    paths = jax_param_paths(module)
    own = dict(module.named_parameters())
    out, used = {}, set()
    for key, (path, name) in paths.items():
        try:
            value = np.asarray(params[path][name])
        except KeyError as e:
            raise KeyError(f'JAX parameters lack {path}/{name} (for {key})') from e
        if value.shape != tuple(own[key].shape):
            raise ValueError(f'{path}/{name}: shape {value.shape}, port expects {tuple(own[key].shape)}')
        out[key] = torch.tensor(value, dtype=dtype)
        used.add((path, name))
    extra = {(p, n) for p, bundle in params.items() for n in bundle} - used
    if extra:
        raise KeyError(f'JAX parameters unknown to the port: {sorted(extra)}')
    return out


def kfac_state_from_jax(opt_state, metas, module: torch.nn.Module) -> dict:
    """The port's KFAC state (``kfac.KFAC.init``'s layout) from a JAX KFAC state
    as numpy-convertible arrays; ``metas`` are the port's discovered layers,
    ``module`` (a module, or a :class:`~.wf.StateStack` with one entry of
    JAX's per-state lists per state) gives the dtype and device."""
    ref = next(module.parameters())
    n_states = len(wf_states(module))
    if len(opt_state['factors']) != n_states:
        raise ValueError(f'a JAX KFAC state of {len(opt_state["factors"])} states for '
                         f'{n_states}')
    paths = [m.path for m in metas]
    out = {'step': int(np.asarray(opt_state['step'])),
           'ema_weight': float(np.asarray(opt_state['ema_weight']))}
    for key in ('factors', 'inverses'):
        out[key] = []
        for state in opt_state[key]:
            if sorted(state) != sorted(paths):
                raise KeyError(f'JAX KFAC {key} are for other layers: '
                               f'{sorted(set(state) ^ set(paths))}')
            out[key].append({})
            for m in metas:
                pair = tuple(torch.tensor(np.asarray(x), dtype=ref.dtype, device=ref.device)
                             for x in state[m.path])
                want = ((m.in_dim + m.has_bias,) * 2, (m.out_dim,) * 2)
                if tuple(tuple(x.shape) for x in pair) != want:
                    raise ValueError(f'{key} of {m.path}: shapes {[x.shape for x in pair]}, '
                                     f'want {want}')
                out[key][-1][m.path] = pair
        if n_states == 1:
            out[key] = out[key][0]
    return out
