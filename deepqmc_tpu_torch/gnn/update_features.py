"""Update features (counterpart of ``deepqmc_tpu/gnn/update_features.py``):
what one interaction's electron update is made of.

Each feature's :meth:`messages` maps the electron embeddings ``h``
``[B, n_el, node_dim]`` and the typed edges (``gnn.graph``) to a list of
per-electron messages ``[B, n_el, width]``, one per entry of ``widths``; the
layer folds them into the new embeddings.  The residual, the per-spin node
sums, the edge sums and the convolution build FermiNet and the PauliNet-style
``default`` ansatz; the self-attention block builds the PsiFormer.
"""

import torch

from .. import fwdlap as fl
from .. import nn
from ..fwdlap import FL, is_fl, tanh, uses_plain_cores
from ..ops import fl_block

__all__ = [
    'ConvolutionElectronUpdateFeature', 'EdgeSumElectronUpdateFeature',
    'NodeAttentionElectronUpdateFeature', 'NodeSumElectronUpdateFeature',
    'ResidualElectronUpdateFeature',
]

_EDGE_TYPES = {'up', 'down', 'same', 'anti', 'ee'}


def _check_edge_types(edge_types):
    unknown = set(edge_types) - _EDGE_TYPES
    if unknown:
        raise ValueError(f'edge types {sorted(unknown)} are not ported (ROADMAP.md, queue 1 item 8)')


class ResidualElectronUpdateFeature(nn.Module):
    """The incoming electron embeddings, unchanged."""

    def __init__(self, n_up, n_down, two_particle_stream_dim, node_dim, edge_dim):
        super().__init__('residual_electron_update_feature')
        self.widths = [node_dim]

    def messages(self, h, edges):
        return [h]


class NodeSumElectronUpdateFeature(nn.Module):
    """Per-spin sums (means with ``normalize``) of the embeddings, tiled to every electron."""

    def __init__(self, n_up, n_down, two_particle_stream_dim, node_dim, edge_dim, *,
                 node_types, normalize):
        super().__init__('node_sum_electron_update_feature')
        if not set(node_types) <= {'up', 'down'}:
            raise ValueError(f'node types {node_types}: want up and/or down')
        self.n_up, self.n_el = n_up, n_up + n_down
        self.node_types, self.normalize = list(node_types), normalize
        self.widths = [node_dim] * len(node_types)

    def messages(self, h, edges):
        parts = {'up': h[..., : self.n_up, :], 'down': h[..., self.n_up :, :]}
        return [
            fl.tile(parts[t].mean(-2, keepdim=True) if self.normalize
                    else parts[t].sum(-2, keepdim=True), -2, self.n_el)
            for t in self.node_types
        ]


class EdgeSumElectronUpdateFeature(nn.Module):
    """Per-receiver sums (means with ``normalize``) of each edge type; 'ee'
    is 'same' plus 'anti', divided by the electron count with ``normalize``."""

    def __init__(self, n_up, n_down, two_particle_stream_dim, node_dim, edge_dim, *,
                 edge_types, normalize):
        super().__init__('edge_sum_electron_update_feature')
        _check_edge_types(edge_types)
        self.n_el = n_up + n_down
        self.edge_types, self.normalize = list(edge_types), normalize
        self.widths = [edge_dim] * len(edge_types)

    def messages(self, h, edges):
        out = []
        for t in self.edge_types:
            if t == 'ee':
                factor = self.n_el if self.normalize else 1.0
                out.append((edges['same'].sum_senders(False)
                            + edges['anti'].sum_senders(False)) / factor)
            else:
                out.append(edges[t].sum_senders(self.normalize))
        return out


class ConvolutionElectronUpdateFeature(nn.Module):
    """PauliNet's convolution: per edge type, ``w_{type}`` of the edges times
    ``h_{type}`` of the sender embeddings, reduced over the senders ('ee':
    'same' plus 'anti', divided by the electron count with ``normalize``).
    Every ported edge type has electrons for senders, so ``h`` always reads
    the electron embeddings; the edges always go through ``w`` (the JAX
    ``w_for_ne=True``)."""

    def __init__(self, n_up, n_down, two_particle_stream_dim, node_dim, edge_dim, *,
                 edge_types, normalize, w_factory, h_factory):
        super().__init__('convolution_electron_update_feature')
        _check_edge_types(edge_types)
        self.n_el, self.dim = n_up + n_down, two_particle_stream_dim
        self.edge_types, self.normalize = list(edge_types), normalize
        nets = {}
        for t in self.edge_types:
            for st in ('same', 'anti') if t == 'ee' else (t,):
                nets[f'w_{st}'] = w_factory(edge_dim, self.dim, name=f'w_{st}')
                nets[f'h_{st}'] = h_factory(node_dim, self.dim, name=f'h_{st}')
        self.nets = torch.nn.ModuleDict(nets)
        self.widths = [self.dim] * len(edge_types)

    def _convolve_type(self, h, edges, edge_type, normalize):
        single = edges[edge_type].single_array
        we = self.nets[f'w_{edge_type}'](single)
        hx = self.nets[f'h_{edge_type}'](h)
        if single.shape[1:].numel() == 0:
            # no edges of this type (one electron of a spin): a zero message,
            # as the JAX package returns, the nets applied all the same
            x = fl.primal(h)
            return x.new_zeros(x.shape[0], self.n_el, self.dim)
        return edges[edge_type].update_from_single_array(we).convolve(hx, normalize)

    def messages(self, h, edges):
        out = []
        for t in self.edge_types:
            if t == 'ee':
                ee = sum(self._convolve_type(h, edges, st, False) for st in ('same', 'anti'))
                out.append(ee / (self.n_el if self.normalize else 1.0))
            else:
                out.append(self._convolve_type(h, edges, t, self.normalize))
        return out


class NodeAttentionElectronUpdateFeature(nn.Module):
    """PsiFormer block: attention + residual, then a tanh MLP + residual.

    With ``block_kernel`` the forward Laplacian of the whole block goes through
    :func:`ops.fl_block.psiformer_block_fl` (one kernel launch on the card), the
    counterpart of the JAX package's fused rule for the named-jit block
    ``_psiformer_block`` (``fwdlap._try_block_rule``), wherever
    :func:`ops.fl_block.takes` says the kernel takes the shape: on the card
    up to 32 electrons (its shared memory).  Above that the block runs the
    per-op FL rules, as the JAX rule falls back to per-primitive
    interpretation.  Plain tensors, such as the sampler's forwards, always
    take the per-op forward.
    """

    def __init__(self, embedding_dim: int, *, num_heads: int, gen: torch.Generator,
                 block_kernel: bool = False):
        super().__init__('node_attention_electron_update_feature')
        head_dim, rem = divmod(embedding_dim, num_heads)
        if rem:
            raise ValueError('embedding_dim must be divisible by num_heads')
        self.block_kernel = block_kernel
        self.attention = nn.MultiHeadAttention(embedding_dim, num_heads, head_dim, gen=gen)
        self.mlp = nn.MLP(
            embedding_dim, embedding_dim, gen=gen, hidden_layers=['log', 2], bias=True,
            last_linear=False, activation=tanh, init='ferminet',
        )
        self.residual = nn.ResidualConnection()
        self.widths = [embedding_dim]

    def block_weights(self):
        """(Wq, Wk, Wv, Wo, W1, b1, W2, b2), the weight operands of the fused block."""
        att, (lin1, lin2) = self.attention, self.mlp.layers
        return att.query.w, att.key.w, att.value.w, att.w, lin1.w, lin1.b, lin2.w, lin2.b

    def messages(self, h, edges):
        return [self(h)]

    def forward(self, h):
        if self.block_kernel and is_fl(h) and fl_block.takes(h.x):
            block = (fl_block.psiformer_block_fl_plain if uses_plain_cores()
                     else fl_block.psiformer_block_fl)
            y, jy, ly = block(h.x, h.jac, h.lap, *self.block_weights(), self.attention.num_heads)
            return FL(y, jy, ly)
        attended = self.residual(h, self.attention(h, h, h))
        return self.residual(attended, self.mlp(attended))
