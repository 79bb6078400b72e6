"""Module naming and parameter initialisers (counterpart of ``deepqmc_tpu/nn/core.py``).

The JAX package addresses a parameter as ``module/path`` -> ``name``, the path
built from snake-cased class names made unique by a ``_<count>`` suffix
(``electron_gnnlayer``, ``electron_gnnlayer_1``, ...) or from the ``name`` a
module is given.  Port modules are named by the same rule when they are
built: an explicit ``name=`` is the segment, else the snake-cased class name
with the count of its siblings of that name built before it within the same
parent's construction.  Every port module carries its segment in
``jax_name``, and :func:`jax_param_paths` rebuilds the JAX address of each
entry of a module's ``state_dict``; ``convert.py`` uses it to load JAX-made
parameters.

The initialisers draw from a ``torch.Generator`` with the same families as
the JAX package (haiku-style variance scaling): the one a module is given,
else the one of the enclosing :func:`init_generator`, the counterpart of the
JAX package's ``init`` frame with its key.  The ansatz factories build every
module inside one, so a configuration tree's partials need no generator.

The dense layers (``Linear`` and the output product of ``MultiHeadAttention``)
call :meth:`Module.tag_dense` after their product, the counterpart of the JAX
package's ``tag_dense``/``apply_instrumented``: inside :func:`instrumented`
each call records its input and its output tensor, from which KFAC takes the
activation factor and (by the gradient with respect to the output) the
sensitivity factor.  Outside that context, in evaluation and in the
forward-Laplacian pass, the tag does nothing.
"""

import contextlib
import contextvars
import math
import re
from typing import Optional

import torch

__all__ = [
    'DenseTaps', 'Module', 'array_init', 'constant_init', 'current_generator',
    'dense_layer_paths', 'init_generator', 'instrumented', 'jax_param_paths', 'ones_init',
    'variance_scaling', 'zeros_init',
]

_GENERATOR = contextvars.ContextVar('init_generator', default=None)


@contextlib.contextmanager
def init_generator(gen: torch.Generator):
    """Within the block, modules built without a generator draw from ``gen``."""
    token = _GENERATOR.set(gen)
    try:
        yield gen
    finally:
        _GENERATOR.reset(token)


def current_generator(gen: Optional[torch.Generator] = None) -> torch.Generator:
    """``gen``, else the generator of the enclosing :func:`init_generator`."""
    gen = gen or _GENERATOR.get()
    if gen is None:
        raise RuntimeError('a module draws its parameters from a generator: pass gen= or '
                           'build it inside nn.init_generator(gen)')
    return gen

TRUNCATED_NORMAL_STDDEV_FACTOR = 0.87962566103423978


_SCOPE = contextvars.ContextVar('module_scope', default=None)


def _snake_case(name: str) -> str:
    return re.sub(r'(?<=[a-z0-9])(?=[A-Z])', '_', name).lower()


class _ModuleMeta(type):
    """Names each module as the JAX package's ``ModuleMeta`` does: an explicit
    ``name=`` verbatim, else the snake-cased class name, suffixed ``_<k>``
    for the k-th sibling of that name built in the same parent's scope."""

    def __call__(cls, *args, **kwargs):
        parent = _SCOPE.get()
        name = kwargs.get('name')
        if name is None:
            base = _snake_case(cls.__name__)
            k = parent.get(base, 0) if parent is not None else 0
            if parent is not None:
                parent[base] = k + 1
            name = base if k == 0 else f'{base}_{k}'
        token = _SCOPE.set({})
        try:
            inst = super().__call__(*args, **kwargs)
        finally:
            _SCOPE.reset(token)
        inst.jax_name = name
        return inst


class Module(torch.nn.Module, metaclass=_ModuleMeta):
    """A ``torch.nn.Module`` that knows its JAX path segment (``jax_name``,
    set when it is built)."""

    jax_name: str = ''
    taps: 'DenseTaps | None' = None  # set only inside ``instrumented``

    def __init__(self, name: Optional[str] = None):
        super().__init__()

    def tag_dense(self, x, out):
        """Record ``(x, out)`` of this dense layer's call while instrumented; ``out``."""
        if self.taps is not None:
            self.taps.record(self, x, out)
        return out


class DenseTaps:
    """What the dense layers saw in one instrumented forward: per layer, per
    call, the input (detached) and the output (still in the autograd graph)."""

    def __init__(self):
        self.calls: dict[torch.nn.Module, list[tuple[torch.Tensor, torch.Tensor]]] = {}

    def record(self, module, x, out):
        if not (isinstance(x, torch.Tensor) and isinstance(out, torch.Tensor)):
            raise TypeError('an instrumented forward takes plain tensors, not FL triples')
        self.calls.setdefault(module, []).append((x.detach(), out))


@contextlib.contextmanager
def instrumented(root: torch.nn.Module):
    """Within the context, each dense layer of ``root`` records its calls in
    the yielded :class:`DenseTaps`; on exit the layers are plain again."""
    taps = DenseTaps()
    modules = [m for m in root.modules() if isinstance(m, Module)]
    for m in modules:
        m.taps = taps
    try:
        yield taps
    finally:
        for m in modules:
            del m.taps


def dense_layer_paths(root: torch.nn.Module) -> dict[torch.nn.Module, str]:
    """Each module of ``root`` that holds a dense weight ``w`` -> the JAX path of it."""
    paths = jax_param_paths(root)
    return {
        mod: paths[f'{name}.w' if name else 'w'][0]
        for name, mod in root.named_modules()
        if isinstance(getattr(mod, 'w', None), torch.nn.Parameter)
    }


def jax_param_paths(root: torch.nn.Module) -> dict[str, tuple[str, str]]:
    """``state_dict`` key -> (JAX module path, JAX parameter name)."""
    out = {}

    def walk(mod, prefix, path):
        for name, _ in mod.named_parameters(recurse=False):
            out[prefix + name] = (path, name)
        for cname, child in mod.named_children():
            seg = getattr(child, 'jax_name', '')
            walk(child, f'{prefix}{cname}.', f'{path}/{seg}' if seg and path else seg or path)

    walk(root, '', getattr(root, 'jax_name', ''))
    return out


def variance_scaling(
    gen: torch.Generator, shape, scale=1.0, mode='fan_in', distribution='truncated_normal',
    dtype=torch.float32,
) -> torch.Tensor:
    """haiku-compatible VarianceScaling draw (``nn.core.variance_scaling``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    fan_out = shape[-1]
    fan = {'fan_in': fan_in, 'fan_out': fan_out, 'fan_avg': (fan_in + fan_out) / 2}[mode]
    var = scale / max(1.0, fan)
    out = torch.empty(shape, dtype=dtype)
    if distribution == 'truncated_normal':
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return out * (math.sqrt(var) / TRUNCATED_NORMAL_STDDEV_FACTOR)
    if distribution == 'normal':
        return out.normal_(0.0, math.sqrt(var), generator=gen)
    if distribution == 'uniform':
        lim = math.sqrt(3.0 * var)
        return out.uniform_(-lim, lim, generator=gen)
    raise ValueError(f'Unknown distribution: {distribution}')


def zeros_init(gen, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def ones_init(gen, shape, dtype=torch.float32):
    """All ones (``nn.core.ones_init``), e.g. the trainable determinant mix."""
    return torch.ones(shape, dtype=dtype)


def constant_init(value):
    """An initialiser of the constant ``value`` (``nn.core.constant_init``)."""
    return lambda gen, shape, dtype=torch.float32: torch.full(shape, float(value), dtype=dtype)


def array_init(value):
    """An initialiser of a fixed array broadcast to the shape (``nn.core.array_init``)."""
    return lambda gen, shape, dtype=torch.float32: torch.as_tensor(
        value, dtype=dtype).expand(shape).clone()
