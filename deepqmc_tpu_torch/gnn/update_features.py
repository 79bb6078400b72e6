"""Update features (counterpart of ``deepqmc_tpu/gnn/update_features.py``):
what one interaction's node updates are made of.

Each feature is built as in the JAX package, ``(n_up, n_down,
two_particle_stream_dim, node_edge_mapping, **options)``, and reads the
widths of the graph it receives from the mapping (``mapping.dims``).  Its
:meth:`messages` maps the nodes (:class:`~.utils.GraphNodes` of nuclear
``[B, n_nuc, d]`` and electron ``[B, n_el, d]`` embeddings) and the typed
edges (``gnn.graph``) to one ``GraphNodes`` message per channel (``names``);
``widths`` and ``nuc_widths`` are the widths of its electron and nuclear
messages.  The residual, the per-spin node sums, the edge sums and the
convolution build FermiNet, the PauliNet-style ``default`` and DeepErwin;
the self-attention blocks the PsiFormer and the transferable ansätze.
"""

from functools import partial
from typing import Optional

import torch

from .. import fwdlap as fl
from .. import nn
from ..fwdlap import FL, is_fl, tanh, uses_plain_cores
from ..ops import fl_block
from .utils import GraphNodes

__all__ = [
    'CombinedNodeAttentionUpdateFeature', 'ConvolutionElectronUpdateFeature',
    'EdgeSumElectronUpdateFeature', 'NodeAttentionElectronUpdateFeature',
    'NodeSumElectronUpdateFeature', 'ResidualElectronUpdateFeature', 'UpdateFeature',
]

_EDGE_TYPES = {'up', 'down', 'same', 'anti', 'ee', 'ne'}


def _check_edge_types(edge_types):
    unknown = set(edge_types) - _EDGE_TYPES
    if unknown:
        raise ValueError(f'edge types {sorted(unknown)}: an electron update takes '
                         f'{sorted(_EDGE_TYPES)}')


class UpdateFeature(nn.Module):
    """Base class: ``messages(nodes, edges)`` -> one ``GraphNodes`` per channel."""

    nuc_widths: tuple = ()

    def __init__(self, n_up, n_down, two_particle_stream_dim, node_edge_mapping,
                 name: Optional[str] = None):
        super().__init__()
        self.n_up, self.n_down = n_up, n_down
        self.n_el = n_up + n_down
        self.two_particle_stream_dim = two_particle_stream_dim
        self.mapping = node_edge_mapping
        self.dims = node_edge_mapping.dims

    def _edge_dim(self, typ):
        return self.dims['same'] if typ == 'ee' else self.dims[typ]


class ResidualElectronUpdateFeature(UpdateFeature):
    """The incoming electron embeddings, unchanged."""

    def __init__(self, *args, name=None):
        super().__init__(*args)
        self.names, self.widths = ['residual'], [self.dims['electrons']]

    def messages(self, nodes, edges):
        return [GraphNodes(None, nodes.electrons)]


class NodeSumElectronUpdateFeature(UpdateFeature):
    """Per-spin sums (means with ``normalize``) of the embeddings, tiled to every electron."""

    def __init__(self, *args, node_types, normalize, name=None):
        super().__init__(*args)
        if not set(node_types) <= {'up', 'down'}:
            raise ValueError(f'node types {node_types}: want up and/or down')
        counts = {'up': self.n_up, 'down': self.n_down}
        if normalize and any(counts[t] == 0 for t in node_types):
            # the JAX package's mean over an empty spin block is NaN: ROADMAP.md, queue 3
            raise ValueError('a node mean over an empty spin block (n_up='
                             f'{self.n_up}, n_down={self.n_down}) is NaN in the JAX package')
        self.node_types, self.normalize = list(node_types), normalize
        self.names = [f'node_{t}' for t in node_types]
        self.widths = [self.dims['electrons']] * len(node_types)

    def messages(self, nodes, edges):
        h = nodes.electrons
        parts = {'up': h[..., : self.n_up, :], 'down': h[..., self.n_up :, :]}
        return [
            GraphNodes(None, fl.tile(parts[t].mean(-2, keepdim=True) if self.normalize
                                     else parts[t].sum(-2, keepdim=True), -2, self.n_el))
            for t in self.node_types
        ]


class EdgeSumElectronUpdateFeature(UpdateFeature):
    """Per-receiver sums (means with ``normalize``) of each edge type; 'ee'
    is 'same' plus 'anti', divided by the electron count with ``normalize``."""

    def __init__(self, *args, edge_types, normalize, name=None):
        super().__init__(*args)
        _check_edge_types(edge_types)
        self.edge_types, self.normalize = list(edge_types), normalize
        self.names = [f'edge_{t}' for t in edge_types]
        self.widths = [self._edge_dim(t) for t in edge_types]

    def messages(self, nodes, edges):
        out = []
        for t in self.edge_types:
            if t == 'ee':
                factor = self.n_el if self.normalize else 1.0
                summed = (edges['same'].sum_senders(False)
                          + edges['anti'].sum_senders(False)) / factor
            else:
                summed = edges[t].sum_senders(self.normalize)
            out.append(GraphNodes(None, summed))
        return out


class ConvolutionElectronUpdateFeature(UpdateFeature):
    """PauliNet's convolution: per edge type, ``w_{type}`` of the edges times
    ``h_{type}`` of the sender embeddings (the nuclei for 'ne'), reduced over
    the senders ('ee': 'same' plus 'anti', divided by the electron count with
    ``normalize``).  Without ``w_for_ne`` the 'ne' edges enter as they are."""

    def __init__(self, *args, edge_types, normalize, w_factory, h_factory, w_for_ne=True,
                 name=None):
        super().__init__(*args)
        _check_edge_types(edge_types)
        self.edge_types, self.normalize = list(edge_types), normalize
        self.w_for_ne = w_for_ne
        nets, widths = {}, {}
        for t in self.edge_types:
            for st in ('same', 'anti') if t == 'ee' else (t,):
                edge_dim = self.dims[st]
                if w_for_ne or st != 'ne':
                    widths[st] = self.two_particle_stream_dim
                    nets[f'w_{st}'] = w_factory(edge_dim, widths[st], name=f'w_{st}')
                else:
                    widths[st] = edge_dim
                sender_dim = self.dims[self.mapping.sender_of(st)]
                nets[f'h_{st}'] = h_factory(sender_dim, widths[st], name=f'h_{st}')
        self.nets = torch.nn.ModuleDict(nets)
        self.names = [f'conv_{t}' for t in edge_types]
        self.widths = [widths['same' if t == 'ee' else t] for t in edge_types]

    def _convolve_type(self, nodes, edges, edge_type, normalize):
        single = edges[edge_type].single_array
        w = self.nets[f'w_{edge_type}'] if f'w_{edge_type}' in self.nets else nn.Identity()
        we = w(single)
        hx = self.nets[f'h_{edge_type}'](self.mapping.sender_data_of(edge_type, nodes))
        if single.shape[1:].numel() == 0:
            # no edges of this type (one electron of a spin): a zero message,
            # as the JAX package returns, the nets applied all the same
            x = fl.primal(nodes.electrons)
            return x.new_zeros(x.shape[0], self.n_el, self.two_particle_stream_dim)
        return edges[edge_type].update_from_single_array(we).convolve(hx, normalize)

    def messages(self, nodes, edges):
        out = []
        for t in self.edge_types:
            if t == 'ee':
                ee = sum(self._convolve_type(nodes, edges, st, False) for st in ('same', 'anti'))
                out.append(GraphNodes(None, ee / (self.n_el if self.normalize else 1.0)))
            else:
                out.append(GraphNodes(None, self._convolve_type(nodes, edges, t, self.normalize)))
        return out


def _attention_block(module, h, mask=None):
    """Attention with its residual, then the MLP with its residual."""
    attended = module.attention(h, h, h, mask)
    if module.attention_residual:
        attended = module.attention_residual(h, attended)
    out = module.mlp(attended)
    return module.mlp_residual(attended, out) if module.mlp_residual else out


class NodeAttentionElectronUpdateFeature(UpdateFeature):
    """PsiFormer block: attention + residual, then an MLP + residual.

    With ``block_kernel`` the forward Laplacian of the whole block goes through
    :func:`ops.fl_block.psiformer_block_fl` (one kernel launch on the card), the
    counterpart of the JAX package's fused rule for the named-jit block
    ``_psiformer_block`` (``fwdlap._try_block_rule``), wherever
    :func:`ops.fl_block.takes` says the kernel takes the shape: on the card
    up to 32 electrons (its shared memory).  Above that the block runs the
    per-op FL rules, as the JAX rule falls back to per-primitive
    interpretation.  Plain tensors, such as the sampler's forwards, always
    take the per-op forward.  The kernel computes the PsiFormer preset's
    block (a two-layer tanh MLP with biases, plain residuals); any other
    block refuses ``block_kernel``.
    """

    def __init__(self, *args, num_heads, mlp_factory, attention_residual, mlp_residual,
                 block_kernel: bool = False, name=None):
        super().__init__(*args)
        embedding_dim = self.dims['electrons']
        head_dim, rem = divmod(embedding_dim, num_heads)
        if rem:
            raise ValueError('embedding_dim must be divisible by num_heads')
        self.attention = nn.MultiHeadAttention(embedding_dim, num_heads, head_dim,
                                               name='attention')
        self.mlp = mlp_factory(embedding_dim, embedding_dim, name='mlp')
        self.attention_residual = attention_residual
        self.mlp_residual = mlp_residual
        self.block_kernel = False
        if block_kernel:
            self.use_block_kernel()
        self.names, self.widths = ['attention'], [embedding_dim]

    @classmethod
    def psiformer(cls, embedding_dim: int, *, num_heads: int, gen: torch.Generator,
                  block_kernel: bool = False):
        """The PsiFormer preset's block on embeddings of ``embedding_dim``."""
        from .utils import NodeEdgeMapping

        mapping = NodeEdgeMapping((), node_data={'dims': {'electrons': embedding_dim}})
        with nn.init_generator(gen):
            return cls(
                0, 0, 0, mapping, num_heads=num_heads,
                mlp_factory=_psiformer_mlp, attention_residual=nn.ResidualConnection(),
                mlp_residual=nn.ResidualConnection(), block_kernel=block_kernel,
            )

    def use_block_kernel(self):
        """Turn the fused block on; only for the block the kernel computes."""
        mlp, d = self.mlp, self.dims['electrons']
        plain = [r for r in (self.attention_residual, self.mlp_residual)
                 if isinstance(r, nn.ResidualConnection) and not r.normalize]
        act = getattr(mlp, 'activation', None)
        if isinstance(act, partial) and not act.args and not act.keywords:
            act = act.func
        fusable = (isinstance(mlp, nn.MLP) and not mlp.last_linear and act is tanh
                   and len(plain) == 2
                   and [tuple(lin.w.shape) for lin in mlp.layers] == [(d, d)] * 2
                   and all(lin.b is not None for lin in mlp.layers))
        if not fusable:
            raise ValueError("block_kernel: the fused kernel computes the PsiFormer preset's "
                             'block only')
        self.block_kernel = True

    def block_weights(self):
        """(Wq, Wk, Wv, Wo, W1, b1, W2, b2), the weight operands of the fused block."""
        att, (lin1, lin2) = self.attention, self.mlp.layers
        return att.query.w, att.key.w, att.value.w, att.w, lin1.w, lin1.b, lin2.w, lin2.b

    def messages(self, nodes, edges):
        return [GraphNodes(None, self(nodes.electrons))]

    def forward(self, h):
        if self.block_kernel and is_fl(h) and fl_block.takes(h.x):
            block = (fl_block.psiformer_block_fl_plain if uses_plain_cores()
                     else fl_block.psiformer_block_fl)
            y, jy, ly = block(h.x, h.jac, h.lap, *self.block_weights(), self.attention.num_heads)
            return FL(y, jy, ly)
        return _attention_block(self, h)


def _psiformer_mlp(in_dim, out_dim, name=None):
    return nn.MLP(in_dim, out_dim, name=name, hidden_layers=['log', 2], bias=True,
                  last_linear=False, activation=tanh, init='ferminet')


class CombinedNodeAttentionUpdateFeature(UpdateFeature):
    """Attention over the nuclei and the electrons together, then an MLP; a
    message to both.  Without ``elec_to_nuc`` the nuclei attend to the
    nuclei only.  The nuclear and electron embeddings must be of one width."""

    def __init__(self, *args, num_heads, mlp_factory, attention_residual, mlp_residual,
                 elec_to_nuc, name=None):
        super().__init__(*args)
        dim = self.dims['electrons']
        if self.dims.get('nuclei') != dim:
            raise ValueError(f"combined attention over nuclei of width {self.dims.get('nuclei')} "
                             f'and electrons of width {dim}: want one width')
        head_dim, rem = divmod(dim, num_heads)
        if rem:
            raise ValueError('embedding_dim must be divisible by num_heads')
        self.attention = nn.MultiHeadAttention(dim, num_heads, head_dim, name='attention')
        self.mlp = mlp_factory(dim, dim, name='mlp')
        self.attention_residual = attention_residual
        self.mlp_residual = mlp_residual
        self.elec_to_nuc = elec_to_nuc
        self.names, self.widths, self.nuc_widths = ['combined_attention'], [dim], [dim]

    def messages(self, nodes, edges):
        n_nuc = nodes.nuclei.shape[-2]
        h = fl.cat([nodes.nuclei, nodes.electrons], -2)
        mask = None
        if not self.elec_to_nuc:
            n = h.shape[-2]
            mask = torch.ones(n, n, dtype=torch.bool, device=fl.primal(h).device)
            mask[:n_nuc, n_nuc:] = False  # nuclei attend only to nuclei
        out = _attention_block(self, h, mask)
        return [GraphNodes(out[..., :n_nuc, :], out[..., n_nuc:, :])]
