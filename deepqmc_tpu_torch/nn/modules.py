"""Neural-network building blocks (counterpart of ``deepqmc_tpu/nn/modules.py``).

Every module acts on walker-batched inputs ``[B, ..., features]`` that are
plain tensors or :class:`~deepqmc_tpu_torch.fwdlap.FL` triples.  Weights keep
the JAX layout ``[in, out]``, so ``y = x @ w + b``.
"""

import math
from collections.abc import Callable
from functools import partial
from typing import Optional

import torch

from .. import fwdlap as fl
from .core import Module, variance_scaling

__all__ = [
    'Linear', 'MLP', 'MultiHeadAttention', 'ResidualConnection', 'SumPool', 'Identity', 'ones_init',
]


def _zeros(gen, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def ones_init(gen, shape, dtype=torch.float32):
    """All ones (``nn.core.ones_init``), e.g. the trainable determinant mix."""
    return torch.ones(shape, dtype=dtype)


_W_INITS = {
    'default': partial(variance_scaling, scale=1.0, mode='fan_in', distribution='truncated_normal'),
    'ferminet': partial(variance_scaling, scale=1.0, mode='fan_in', distribution='normal'),
}
_B_INITS = {
    'default': _zeros,
    'ferminet': partial(variance_scaling, scale=1.0, mode='fan_out', distribution='normal'),
}


class Linear(Module):
    """Dense layer ``y = x @ w + b`` (``nn.modules.Linear``)."""

    def __init__(
        self, in_dim: int, out_dim: int, *, gen: torch.Generator, with_bias: bool = True,
        w_init: Optional[Callable] = None, b_init: Optional[Callable] = None,
        name: str = 'linear',
    ):
        super().__init__(name)
        self.w = torch.nn.Parameter((w_init or _W_INITS['default'])(gen, (in_dim, out_dim)))
        self.b = (
            torch.nn.Parameter((b_init or _zeros)(gen, (out_dim,))) if with_bias else None
        )

    def forward(self, x):
        out = x @ self.w
        return self.tag_dense(x, out if self.b is None else out + self.b)


class MLP(Module):
    """Multilayer perceptron with log-spaced widths (``nn.modules.MLP``)."""

    def __init__(
        self, in_dim: int, out_dim: int, *, gen: torch.Generator,
        hidden_layers: tuple, bias: bool, last_linear: bool, activation: Optional[Callable],
        init: str, name: str = 'mlp',
    ):
        super().__init__(name)
        kind, n_hidden = hidden_layers
        if kind != 'log':
            raise ValueError("the port's MLP takes hidden_layers=('log', n) only")
        qs = [k / n_hidden for k in range(1, n_hidden + 1)]
        dims = [round(in_dim ** (1 - q) * out_dim**q) for q in qs]
        self.activation = activation
        self.last_linear = last_linear
        layers = []
        for idx, (d_in, d_out) in enumerate(zip([in_dim, *dims[:-1]], dims)):
            layers.append(Linear(
                d_in, d_out, gen=gen, with_bias=bias, w_init=_W_INITS[init],
                b_init=_B_INITS[init], name=f'linear_{idx}',
            ))
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, x):
        n = len(self.layers)
        for idx, layer in enumerate(self.layers):
            x = layer(x)
            if idx < n - 1 or not self.last_linear:
                x = self.activation(x)
        return x


class MultiHeadAttention(Module):
    """Dot-product attention over the token axis -2 (``nn.modules.MultiHeadAttention``).

    The projections are head-flat ``[token, H*dh]``; the softmax core is
    :func:`fwdlap.mha_core`, which on FL operands runs the attention kernel.
    The output product ``attended @ w`` is a dense layer for KFAC, as in JAX.
    """

    def __init__(self, in_dim: int, num_heads: int, key_size: int, *, gen: torch.Generator,
                 name: str = 'attention'):
        super().__init__(name)
        self.num_heads = num_heads
        init = _W_INITS['ferminet']  # variance_scaling(1.0, 'fan_in', 'normal')
        dm = num_heads * key_size
        self.query = Linear(in_dim, dm, gen=gen, with_bias=False, w_init=init, name='query')
        self.key = Linear(in_dim, dm, gen=gen, with_bias=False, w_init=init, name='key')
        self.value = Linear(in_dim, dm, gen=gen, with_bias=False, w_init=init, name='value')
        self.w = torch.nn.Parameter(init(gen, (dm, in_dim)))

    def forward(self, q, k, v):
        attended = fl.mha_core(self.query(q), self.key(k), self.value(v), self.num_heads)
        return self.tag_dense(attended, attended @ self.w)


class ResidualConnection:
    """Shape-gated residual: adds only when shapes match, then divides by
    sqrt(2) with ``normalize``.  On a dict of edge containers (``gnn.graph``)
    it acts leaf by leaf, as the JAX package's ``tree_map`` does."""

    def __init__(self, *, normalize: bool = False):
        self.normalize = normalize

    def __call__(self, inp, update):
        if isinstance(update, dict):
            return {k: self(inp[k], v) for k, v in update.items()}
        if hasattr(update, 'leaves'):
            return update.from_leaves([self(a, b) for a, b in zip(inp.leaves(), update.leaves())])
        if inp.shape != update.shape:
            return update
        out = inp + update
        return out / math.sqrt(2) if self.normalize else out


class SumPool:
    """Sum over the last axis, kept (determinant mixing)."""

    def __call__(self, x):
        return x.sum(-1, keepdim=True)


class Identity:
    """No-op stand-in for optional subnetworks."""

    def __call__(self, x):
        return x
