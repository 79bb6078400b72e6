"""Module naming and parameter initialisers (counterpart of ``deepqmc_tpu/nn/core.py``).

The JAX package addresses a parameter as ``module/path`` -> ``name``, the path
built from snake-cased class names made unique by a ``_<count>`` suffix
(``electron_gnnlayer``, ``electron_gnnlayer_1``, ...).  Here every port module
carries the path segment of its JAX counterpart in ``jax_name``, and
:func:`jax_param_paths` rebuilds the JAX address of each entry of a module's
``state_dict``; ``convert.py`` uses it to load JAX-made parameters.

The initialisers draw from an explicit ``torch.Generator`` with the same
families as the JAX package (haiku-style variance scaling).

The dense layers (``Linear`` and the output product of ``MultiHeadAttention``)
call :meth:`Module.tag_dense` after their product, the counterpart of the JAX
package's ``tag_dense``/``apply_instrumented``: inside :func:`instrumented`
each call records its input and its output tensor, from which KFAC takes the
activation factor and (by the gradient with respect to the output) the
sensitivity factor.  Outside that context, in evaluation and in the
forward-Laplacian pass, the tag does nothing.
"""

import contextlib
import math

import torch

__all__ = [
    'DenseTaps', 'Module', 'dense_layer_paths', 'instrumented', 'jax_param_paths',
    'variance_scaling',
]

TRUNCATED_NORMAL_STDDEV_FACTOR = 0.87962566103423978


class Module(torch.nn.Module):
    """A ``torch.nn.Module`` that knows its JAX path segment."""

    jax_name: str = ''
    taps: 'DenseTaps | None' = None  # set only inside ``instrumented``

    def __init__(self, jax_name: str):
        super().__init__()
        self.jax_name = jax_name

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
    """haiku-compatible VarianceScaling draw (``nn.core.variance_scaling``), in
    the two distributions the PsiFormer uses."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    fan_out = shape[-1]
    fan = {'fan_in': fan_in, 'fan_out': fan_out}[mode]
    var = scale / max(1.0, fan)
    out = torch.empty(shape, dtype=dtype)
    if distribution == 'truncated_normal':
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return out * (math.sqrt(var) / TRUNCATED_NORMAL_STDDEV_FACTOR)
    if distribution == 'normal':
        return out.normal_(0.0, math.sqrt(var), generator=gen)
    raise ValueError(f'Unknown distribution: {distribution}')
