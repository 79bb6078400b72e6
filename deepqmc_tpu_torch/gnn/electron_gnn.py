"""The electron GNN (counterpart of ``deepqmc_tpu/gnn/electron_gnn.py``):
electron embeddings from the electron-nucleus edges, typed electron-electron
edges with their features, and interactions whose update features are folded
by the 'concatenate' rule through the net ``g``.

The presets configure it as FermiNet and the PauliNet-style ``default``
(residual, node sums, edge sums or convolutions; a shared two-particle stream
refreshed by one net ``u`` over every edge type) or as the PsiFormer (no
edges, one self-attention update, ``g`` the identity).  The nuclear
embeddings and the other options of the JAX package are not ported
(ROADMAP.md, queue 1 item 8).
"""

import torch

from .. import fwdlap as fl
from .. import nn
from .graph import MolecularGraphEdgeBuilder

__all__ = ['ElectronEmbedding', 'ElectronGNN', 'ElectronGNNLayer']


class ElectronEmbedding(nn.Module):
    """Electron-nucleus edge features per electron (+ the spin with
    ``use_spin``), projected to the embedding width by a bias-free linear layer
    with ``project_to_embedding_dim``; ``out_dim`` is the width it returns."""

    def __init__(self, n_nuc, n_up, n_down, embedding_dim, *, ne_features, gen,
                 use_spin=True, project_to_embedding_dim=True):
        super().__init__('electron_embedding')
        self.ne_features = ne_features
        self.use_spin = use_spin
        spin = torch.cat([torch.ones(n_up), -torch.ones(n_down)])[:, None]
        self.register_buffer('spin', spin, persistent=False)
        in_dim = n_nuc * len(ne_features) + use_spin
        self.linear = (nn.Linear(in_dim, embedding_dim, gen=gen, with_bias=False)
                       if project_to_embedding_dim else None)
        self.out_dim = embedding_dim if project_to_embedding_dim else in_dim

    def forward(self, r, R):
        # [B, n_el, n_nuc, 3] receiver (electron) minus sender (nucleus)
        x = self.ne_features(r[..., :, None, :] - R).flatten(-2)
        if self.use_spin:
            x = fl.cat([x, self.spin.to(x.dtype)], -1)
        return self.linear(x) if self.linear is not None else x


class ElectronGNNLayer(nn.Module):
    """One interaction: the update features' messages, concatenated, through
    ``g``, with the electron residual; then, with ``deep_features='shared'``
    and unless it is the last layer, the edges' refresh by ``u`` with the
    two-particle residual (the messages read the incoming edges).

    ``node_dim`` and ``edge_dim`` are the widths this layer receives;
    ``out_dims`` the widths it passes on.
    """

    def __init__(
        self, ilayer, n_interactions, n_up, n_down, embedding_dim, two_particle_stream_dim,
        node_dim, edge_dim, *, update_features, subnet_factory, subnet_factory_by_lbl=None,
        electron_residual=None, two_particle_residual=None, deep_features=False,
    ):
        super().__init__('electron_gnnlayer' if ilayer == 0 else f'electron_gnnlayer_{ilayer}')
        if deep_features not in (False, 'shared'):
            raise ValueError(f"deep_features {deep_features!r}: the port has False and 'shared' "
                             'only (ROADMAP.md, queue 1 item 8)')
        factories = {lbl: (subnet_factory_by_lbl or {}).get(lbl) or subnet_factory
                     for lbl in ('g', 'u')}
        last = ilayer == n_interactions - 1
        self.u = (factories['u'](edge_dim, two_particle_stream_dim, name='u')
                  if deep_features and not last else None)
        self.update_features = torch.nn.ModuleList(
            uf(n_up, n_down, two_particle_stream_dim, node_dim, edge_dim)
            for uf in update_features
        )
        in_dim = sum(w for uf in self.update_features for w in uf.widths)
        self.g = factories['g'](in_dim, embedding_dim, name='g')
        self.electron_residual = electron_residual
        self.two_particle_residual = two_particle_residual
        self.out_dims = (in_dim if isinstance(self.g, nn.Identity) else embedding_dim,
                         two_particle_stream_dim if self.u is not None else edge_dim)

    def _two_particle_update(self, edges):
        """Every edge of every type through the one net ``u``, concatenated
        along the edge axes (as the JAX package's shared call), then split back."""
        order = list(edges)
        arrays = [edges[t].single_array for t in order]
        dim = 1 - arrays[0].dim()  # the first axis after the walkers'
        fused = self.u(arrays[0] if len(arrays) == 1 else fl.cat(arrays, dim))
        new, offset = {}, 0
        tail = (slice(None),) * (-dim - 1)
        for t, a in zip(order, arrays):
            n = a.shape[dim]
            new[t] = edges[t].update_from_single_array(fused[(..., slice(offset, offset + n),
                                                              *tail)])
            offset += n
        return self.two_particle_residual(edges, new) if self.two_particle_residual else new

    def forward(self, h, edges):
        """``(h, edges) -> (h, edges)``."""
        msgs = [m for uf in self.update_features for m in uf.messages(h, edges)]
        new = self.g(msgs[0] if len(msgs) == 1 else fl.cat(msgs, -1))
        h = self.electron_residual(h, new) if self.electron_residual else new
        if self.u is not None:
            edges = self._two_particle_update(edges)
        return h, edges


class ElectronGNN(nn.Module):
    """The embedding, the typed edges featurised by ``edge_features`` (type ->
    feature; same-spin edges keep their self-edges with ``self_interaction``),
    and ``n_interactions`` layers from ``layer_factory(ilayer, n_interactions,
    n_up, n_down, embedding_dim, two_particle_stream_dim, node_dim, edge_dim)``;
    returns the electron embeddings ``[B, n_el, embedding_dim]``."""

    def __init__(self, hamil, embedding_dim, *, n_interactions, electron_embedding,
                 layer_factory, edge_features=None, self_interaction=False,
                 two_particle_stream_dim=32):
        super().__init__('electron_gnn')
        n_up, n_down = hamil.n_up, hamil.n_down
        self.edge_features = dict(edge_features or {})
        self.build_edges = MolecularGraphEdgeBuilder(
            n_up, n_down, list(self.edge_features), self_interaction=self_interaction)
        edge_dims = {len(f) for f in self.edge_features.values()}
        if len(edge_dims) > 1:
            raise ValueError('the edge types need features of one width (one shared stream)')
        self.electron_embedding = electron_embedding
        node_dim, edge_dim = electron_embedding.out_dim, edge_dims.pop() if edge_dims else 0
        layers = []
        for i in range(n_interactions):
            layers.append(layer_factory(i, n_interactions, n_up, n_down, embedding_dim,
                                        two_particle_stream_dim, node_dim, edge_dim))
            node_dim, edge_dim = layers[-1].out_dims
        self.layers = torch.nn.ModuleList(layers)
        self.embedding_dim = node_dim

    def edge_factory(self, r):
        """The typed edges, each featurised through its ``single_array``."""
        raw = self.build_edges(r)
        return {t: raw[t].update_from_single_array(f(raw[t].single_array))
                for t, f in self.edge_features.items()}

    def forward(self, r, R):
        h, edges = self.electron_embedding(r, R), self.edge_factory(r)
        for layer in self.layers:
            h, edges = layer(h, edges)
        return h
