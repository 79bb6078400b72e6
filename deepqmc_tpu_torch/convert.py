"""JAX parameters -> the port's ``state_dict``; JAX KFAC state -> the port's.

The JAX package keeps parameters as ``{module/path: {name: array}}``; the port
records each parameter's JAX address (``nn.core.jax_param_paths``), so the
conversion is a lookup.  Weights share the JAX layout (``[in, out]``), and so
do the KFAC factors and inverses, which both packages key by the layer's path.
"""

import numpy as np
import torch

from .nn import jax_param_paths

__all__ = ['kfac_state_from_jax', 'state_dict_from_jax']


def state_dict_from_jax(params, module: torch.nn.Module, dtype=torch.float64) -> dict:
    """A ``state_dict`` for ``module`` from a JAX parameter dict of numpy-convertible
    arrays; raises if a parameter is missing on either side or has another shape."""
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
    of one electronic state as numpy-convertible arrays; ``metas`` are the
    port's discovered layers, ``module`` gives the dtype and device."""
    ref = next(module.parameters())
    if len(opt_state['factors']) != 1:
        raise NotImplementedError('the port takes one electronic state')
    paths = [m.path for m in metas]
    out = {'step': int(np.asarray(opt_state['step'])),
           'ema_weight': float(np.asarray(opt_state['ema_weight']))}
    for key in ('factors', 'inverses'):
        state = opt_state[key][0]
        if sorted(state) != sorted(paths):
            raise KeyError(f'JAX KFAC {key} are for other layers: {sorted(set(state) ^ set(paths))}')
        out[key] = {}
        for m in metas:
            pair = tuple(torch.tensor(np.asarray(x), dtype=ref.dtype, device=ref.device)
                         for x in state[m.path])
            want = ((m.in_dim + m.has_bias,) * 2, (m.out_dim,) * 2)
            if tuple(tuple(x.shape) for x in pair) != want:
                raise ValueError(f'{key} of {m.path}: shapes {[x.shape for x in pair]}, want {want}')
            out[key][m.path] = pair
    return out
