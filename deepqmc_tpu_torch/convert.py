"""JAX parameters -> the port's ``state_dict``.

The JAX package keeps parameters as ``{module/path: {name: array}}``; the port
records each parameter's JAX address (``nn.core.jax_param_paths``), so the
conversion is a lookup.  Weights share the JAX layout (``[in, out]``).
"""

import numpy as np
import torch

from .nn import jax_param_paths

__all__ = ['state_dict_from_jax']


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
