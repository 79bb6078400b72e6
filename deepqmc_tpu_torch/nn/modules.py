"""Neural-network building blocks (counterpart of ``deepqmc_tpu/nn/modules.py``).

Every module acts on walker-batched inputs ``[B, ..., features]`` that are
plain tensors or :class:`~deepqmc_tpu_torch.fwdlap.FL` triples.  Weights keep
the JAX layout ``[in, out]``, so ``y = x @ w + b``.  A module takes the JAX
class's keyword arguments; what the JAX class learns from its input at the
first call (the input width) the port's takes as its first argument.
"""

import math
from collections.abc import Callable, Sequence
from functools import partial
from typing import Optional, Union

import torch

from .. import fwdlap as fl
from .core import Module, current_generator, ones_init, variance_scaling, zeros_init

__all__ = [
    'GLU', 'Embed', 'Identity', 'LayerNorm', 'Linear', 'MLP', 'MultiHeadAttention',
    'ResidualConnection', 'SumPool', 'ones_init', 'ssp',
]


def ssp(x):
    """Shifted softplus: softplus(x) + log(1/2)."""
    return fl.softplus(x) + math.log(0.5)


_W_INITS = {
    'default': partial(variance_scaling, scale=1.0, mode='fan_in', distribution='truncated_normal'),
    'ferminet': partial(variance_scaling, scale=1.0, mode='fan_in', distribution='normal'),
    'deeperwin': partial(variance_scaling, scale=1.0, mode='fan_avg', distribution='uniform'),
}
_B_INITS = {
    'default': zeros_init,
    'ferminet': partial(variance_scaling, scale=1.0, mode='fan_out', distribution='normal'),
    'deeperwin': zeros_init,
}


class Linear(Module):
    """Dense layer ``y = x @ w + b`` (``nn.modules.Linear``)."""

    def __init__(
        self, in_dim: int, out_dim: int, *, gen: Optional[torch.Generator] = None,
        with_bias: bool = True, w_init: Optional[Callable] = None,
        b_init: Optional[Callable] = None, name: Optional[str] = None,
    ):
        super().__init__()
        gen = current_generator(gen)
        self.w = torch.nn.Parameter((w_init or _W_INITS['default'])(gen, (in_dim, out_dim)))
        self.b = (
            torch.nn.Parameter((b_init or zeros_init)(gen, (out_dim,))) if with_bias else None
        )

    def forward(self, x):
        out = x @ self.w
        return self.tag_dense(x, out if self.b is None else out + self.b)


class MLP(Module):
    """Multilayer perceptron (``nn.modules.MLP``): ``hidden_layers`` is
    ``('log', n)`` for n layers of log-interpolated widths or the explicit
    hidden widths; ``bias`` True, False or 'not_last'; ``init`` 'default',
    'ferminet', 'deeperwin' or an initialiser ``(gen, shape) -> tensor`` of
    both weights and biases."""

    def __init__(
        self, in_dim: int, out_dim: int, name: Optional[str] = None, *,
        gen: Optional[torch.Generator] = None, hidden_layers: Sequence[Union[int, str]],
        bias: Union[bool, str], last_linear: bool, activation: Optional[Callable],
        init: Union[str, Callable],
    ):
        super().__init__()
        if bias not in (True, False, 'not_last'):
            raise ValueError(f"MLP bias {bias!r}: want True, False or 'not_last'")
        hidden_layers = list(hidden_layers or [])
        if len(hidden_layers) == 2 and hidden_layers[0] == 'log':
            n_hidden = hidden_layers[1]
            qs = [k / n_hidden for k in range(1, n_hidden + 1)]
            dims = [round(in_dim ** (1 - q) * out_dim**q) for q in qs]
        else:
            dims = [*hidden_layers, out_dim]
        w_init, b_init = (_W_INITS[init], _B_INITS[init]) if isinstance(init, str) else (init, init)
        self.activation = activation
        self.last_linear = last_linear
        layers = []
        for idx, (d_in, d_out) in enumerate(zip([in_dim, *dims[:-1]], dims)):
            with_bias = bias is True or (bias == 'not_last' and idx < len(dims) - 1)
            layers.append(Linear(
                d_in, d_out, gen=gen, with_bias=with_bias, w_init=w_init, b_init=b_init,
                name=f'linear_{idx}',
            ))
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, x):
        n = len(self.layers)
        for idx, layer in enumerate(self.layers):
            x = layer(x)
            if idx < n - 1 or not self.last_linear:
                x = self.activation(x)
        return x


class LayerNorm(Module):
    """Last-axis layer normalisation, optionally with scale and offset."""

    def __init__(self, in_dim: int, *, create_scale: bool = False, create_offset: bool = False,
                 eps: float = 1e-5, name: Optional[str] = None):
        super().__init__()
        self.eps = eps
        self.scale = torch.nn.Parameter(torch.ones(in_dim)) if create_scale else None
        self.offset = torch.nn.Parameter(torch.zeros(in_dim)) if create_offset else None

    def forward(self, x):
        centred = x - x.mean(-1, keepdim=True)
        var = (centred * centred).mean(-1, keepdim=True)
        out = centred * fl.pow(var + self.eps, -0.5)
        if self.scale is not None:
            out = out * self.scale
        if self.offset is not None:
            out = out + self.offset
        return out


class GLU(Module):
    """Gated linear unit ``activation(W x) * (V y)``, optionally after a layer
    norm of each input (``nn.modules.GLU``)."""

    def __init__(self, in_dim: int, out_dim: int, name: Optional[str] = None, *,
                 gen: Optional[torch.Generator] = None, bias: bool = True,
                 layer_norm_before: bool = True, activation: Callable = fl.sigmoid,
                 b_init: Optional[Callable] = None):
        super().__init__()
        self.activation = activation
        self.norms = (torch.nn.ModuleList([LayerNorm(in_dim), LayerNorm(in_dim)])
                      if layer_norm_before else None)
        self.W = Linear(in_dim, out_dim, gen=gen, with_bias=bias, b_init=b_init, name='W')
        self.V = Linear(in_dim, out_dim, gen=gen, with_bias=bias, b_init=b_init, name='V')

    def forward(self, x, y):
        if self.norms is not None:
            x, y = self.norms[0](x), self.norms[1](y)
        return self.activation(self.W(x)) * self.V(y)


class Embed(Module):
    """Embedding lookup table ``embeddings`` ``[vocab_size, embed_dim]``."""

    def __init__(self, vocab_size: int, embed_dim: int, name: Optional[str] = None, *,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.embeddings = torch.nn.Parameter(
            variance_scaling(current_generator(gen), (vocab_size, embed_dim)))

    def forward(self, idx):
        return self.embeddings[idx]


class MultiHeadAttention(Module):
    """Dot-product attention over the token axis -2 (``nn.modules.MultiHeadAttention``).

    The projections are head-flat ``[token, H*dh]``; the softmax core is
    :func:`fwdlap.mha_core`, which on FL operands runs the attention kernel
    (with a ``mask`` ``[n, n]``, where False keys are left out, its plain
    version: the kernel has no mask, as the JAX package's masked branch has
    no fused core).  The output product ``attended @ w`` is a dense layer for
    KFAC, as in JAX.
    """

    def __init__(self, in_dim: int, num_heads: int, key_size: int, *,
                 gen: Optional[torch.Generator] = None, name: Optional[str] = None):
        super().__init__()
        gen = current_generator(gen)
        self.num_heads = num_heads
        init = _W_INITS['ferminet']  # variance_scaling(1.0, 'fan_in', 'normal')
        dm = num_heads * key_size
        self.query = Linear(in_dim, dm, gen=gen, with_bias=False, w_init=init, name='query')
        self.key = Linear(in_dim, dm, gen=gen, with_bias=False, w_init=init, name='key')
        self.value = Linear(in_dim, dm, gen=gen, with_bias=False, w_init=init, name='value')
        self.w = torch.nn.Parameter(init(gen, (dm, in_dim)))

    def forward(self, q, k, v, mask=None):
        attended = fl.mha_core(self.query(q), self.key(k), self.value(v), self.num_heads,
                               mask=mask)
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
    """Sum over the last axis, kept (determinant mixing); built as the mix
    ``conf_coeff(in_dim, 1, name=...)``."""

    def __init__(self, in_dim: Optional[int] = None, out_dim: int = 1, name: Optional[str] = None):
        if out_dim != 1:
            raise ValueError(f'SumPool out_dim {out_dim}: want 1')

    def __call__(self, x):
        return x.sum(-1, keepdim=True)


class Identity:
    """No-op stand-in for optional subnetworks."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x):
        return x
