"""The electron GNN (counterpart of ``deepqmc_tpu/gnn/electron_gnn.py``):
nuclear and electron embeddings, typed edges with their features, and
interactions whose update features' messages fold into the new embeddings
by an update rule.

Every class takes the JAX class's arguments.  What the JAX package learns
from its inputs at the first call the port's layers are told when they are
built: a layer reads the widths of the graph it receives from
``node_data['dims']`` and says what it passes on in ``out_dims``; an
embedding says its width in ``out_dim``.  The nuclei are constants of the
forward Laplacian, batched over the walkers (so that every dense layer sees
a walker axis, as KFAC needs); the electrons are FLs.
"""

from typing import Optional

import torch

from .. import fwdlap as fl
from .. import nn
from .graph import MolecularGraphEdgeBuilder
from .utils import GraphNodes, NodeEdgeMapping

__all__ = ['ElectronEmbedding', 'ElectronGNN', 'ElectronGNNLayer', 'NucleiEmbedding',
           'PermutationInvariantEmbedding']


def _elementwise_sum(arrays):
    total = arrays[0]
    for a in arrays[1:]:
        total = total + a
    return total


def _stack(arrays):
    """The messages on a new axis -3 (``jnp.stack`` of per-walker arrays)."""
    return fl.cat([a[..., None, :, :] for a in arrays], -3)


# How a node family folds its list of per-channel messages into one update:
# (nets, messages) -> update, ``nets`` one net or, for 'featurewise', one per channel.
_NODE_UPDATE_RULES = {
    'concatenate': lambda nets, msgs: nets(msgs[0] if len(msgs) == 1 else fl.cat(msgs, -1)),
    'sum': lambda nets, msgs: nets(_elementwise_sum(msgs)),
    'featurewise_shared': lambda nets, msgs: nets(_stack(msgs)).sum(-3),
    'featurewise': lambda nets, msgs: _elementwise_sum([net(m) for net, m in zip(nets, msgs)]),
}

#: update rules whose messages must already live in the embedding dimension
_WIDTH_PRESERVING_RULES = frozenset({'sum', 'featurewise_shared'})


class ElectronGNNLayer(nn.Module):
    """One interaction: every update feature's messages folded by
    ``update_rule`` through ``g`` (electrons) and ``g_nuc`` (nuclei, when a
    feature sends them), with the residuals; then, with ``deep_features``
    ('shared': one net ``u`` over every edge type; 'separate': ``u{type}``
    per type) and unless it is the last layer, the edges' refresh with the
    two-particle residual.  The messages read the incoming edges.  The last
    layer leaves out the edges that feed the nuclei ('nn', 'en')."""

    def __init__(
        self, n_interactions, ilayer, n_nuc, n_up, n_down, embedding_dim, edge_types,
        self_interaction, node_data, two_particle_stream_dim, *, electron_residual,
        nucleus_residual, two_particle_residual, deep_features, update_features, update_rule,
        subnet_factory=None, subnet_factory_by_lbl=None, name: Optional[str] = None,
    ):
        super().__init__()
        self.last_layer = ilayer == n_interactions - 1
        self.edge_types = tuple(typ for typ in edge_types
                                if not self.last_layer or typ not in {'nn', 'en'})
        self.mapping = NodeEdgeMapping(self.edge_types, node_data=node_data)
        dims = node_data['dims']
        if update_rule not in _NODE_UPDATE_RULES:
            raise ValueError(f'unknown update_rule: {update_rule!r}')
        if update_rule in _WIDTH_PRESERVING_RULES and embedding_dim != two_particle_stream_dim:
            raise ValueError(f'update_rule {update_rule!r} needs embedding_dim =='
                             ' two_particle_stream_dim')
        if deep_features not in (False, 'shared', 'separate'):
            raise ValueError(f'unknown deep_features: {deep_features!r}')
        self.deep_features, self.update_rule = deep_features, update_rule
        factories = {lbl: (subnet_factory_by_lbl or {}).get(lbl) or subnet_factory
                     for lbl in ('g', 'u')}
        edge_out = {t: dims[t] for t in self.edge_types}
        self.u = None
        if deep_features and not self.last_layer and self.edge_types:
            if deep_features == 'shared':
                widths = {dims[t] for t in self.edge_types}
                if len(widths) > 1:
                    raise ValueError("deep_features='shared' runs every edge type through one "
                                     f'net: their widths {sorted(widths)} differ')
                self.u = factories['u'](widths.pop(), two_particle_stream_dim, name='u')
            else:
                self.u = torch.nn.ModuleDict({
                    t: factories['u'](dims[t], two_particle_stream_dim, name=f'u{t}')
                    for t in self.edge_types})
            edge_out = dict.fromkeys(self.edge_types, two_particle_stream_dim)
        self.update_features = torch.nn.ModuleList(
            uf(n_up, n_down, two_particle_stream_dim, self.mapping) for uf in update_features)
        names = [n for uf in self.update_features for n in uf.names]
        widths = [w for uf in self.update_features for w in uf.widths]
        nuc_widths = [w for uf in self.update_features for w in uf.nuc_widths]
        self.g_factory = factories['g']
        self.g, el_out = self._one_particle_nets(widths, embedding_dim, 'g', names)
        self.g_nuc, nuc_out = None, dims.get('nuclei')
        if nuc_out is not None and nuc_widths:
            self.g_nuc, nuc_out = self._one_particle_nets(nuc_widths, nuc_out, 'g_nuc', names)
        self.electron_residual = electron_residual
        self.nucleus_residual = nucleus_residual
        self.two_particle_residual = two_particle_residual
        self.out_dims = {'electrons': el_out, 'nuclei': nuc_out, **edge_out}

    def _one_particle_nets(self, widths, dim, tag, names):
        """The net(s) of the update rule for messages of ``widths`` into ``dim``,
        and the width they give."""
        if self.update_rule == 'featurewise':
            nets = [self.g_factory(w, dim, name=f'{tag}_{n}') for w, n in zip(widths, names)]
            out = widths[0] if isinstance(nets[0], nn.Identity) else dim
            modules = [n for n in nets if isinstance(n, torch.nn.Module)]
            return (torch.nn.ModuleList(nets) if len(modules) == len(nets) else nets), out
        in_dim = sum(widths) if self.update_rule == 'concatenate' else widths[0]
        net = self.g_factory(in_dim, dim, name=tag)
        return net, in_dim if isinstance(net, nn.Identity) else dim

    @staticmethod
    def _update(rule, old, nets, messages, residual):
        new = _NODE_UPDATE_RULES[rule](nets, messages)
        return residual(old, new) if residual else new

    def _two_particle_update(self, edges):
        if self.deep_features == 'shared':
            # every edge of every type through the one net, concatenated along
            # the edge axes (as the JAX package's shared call), then split back
            order = list(edges)
            arrays = [edges[t].single_array for t in order]
            dim = 1 - arrays[0].dim()  # the first axis after the walkers'
            fused = self.u(arrays[0] if len(arrays) == 1 else fl.cat(arrays, dim))
            new, offset = {}, 0
            tail = (slice(None),) * (-dim - 1)
            for t, a in zip(order, arrays):
                n = a.shape[dim]
                new[t] = edges[t].update_from_single_array(
                    fused[(..., slice(offset, offset + n), *tail)])
                offset += n
        else:
            new = {t: e.update_from_single_array(self.u[t](e.single_array))
                   for t, e in edges.items()}
        return self.two_particle_residual(edges, new) if self.two_particle_residual else new

    def forward(self, nodes, edges):
        """``(GraphNodes, edges) -> (GraphNodes, edges)``."""
        msgs = [m for uf in self.update_features for m in uf.messages(nodes, edges)]
        el_msgs = [m.electrons for m in msgs if m.electrons is not None]
        nuc_msgs = [m.nuclei for m in msgs if m.nuclei is not None]
        electrons = self._update(self.update_rule, nodes.electrons, self.g, el_msgs,
                                 self.electron_residual)
        nuclei = nodes.nuclei
        if self.g_nuc is not None:
            nuclei = self._update(self.update_rule, nuclei, self.g_nuc, nuc_msgs,
                                  self.nucleus_residual)
        if self.u is not None:
            edges = self._two_particle_update({t: edges[t] for t in self.edge_types})
        return GraphNodes(nuclei, electrons), edges


def _atom_type_ids(charges) -> torch.Tensor:
    """Integer id per nucleus, identical charges sharing an id (by sorted charge)."""
    return torch.unique(torch.as_tensor(charges, dtype=torch.float64), return_inverse=True)[1]


def _one_hot_charges(charges, n_classes) -> torch.Tensor:
    return torch.nn.functional.one_hot(_atom_type_ids(charges), n_classes).double()


def _spin_column(n_up, n_down) -> torch.Tensor:
    """A +1/-1 per-electron spin feature column."""
    return torch.cat([torch.ones(n_up), -torch.ones(n_down)])[:, None].double()


def _silu_mlp(in_dim, width, name, hidden):
    """The two-layer silu MLP shape shared by the embedding modules."""
    return nn.MLP(in_dim, width, name=name, hidden_layers=(hidden,), bias=True,
                  last_linear=True, activation=fl.silu, init='ferminet')


def _batched(t: torch.Tensor, like) -> torch.Tensor:
    """A constant ``[...]`` broadcast over the walkers of ``like`` ``[B, ...]``,
    in its dtype and on its device."""
    x = fl.primal(like)
    return t.to(dtype=x.dtype, device=x.device).expand(x.shape[0], *t.shape)


class NucleiEmbedding(nn.Module):
    """Initial nuclear embeddings ``[B, n_nuc, embedding_dim]``: from a token
    per nucleus (its charge with ``atom_type_embedding``, else its index)
    through ``subnet_type`` 'mlp' (or, 'embed', a table of atom types or
    indices); or, with ``edge_features``, geometry-aware, as the sum over
    the senders of an MLP of the 'nn' edge features and the sender's atom
    type, through a second MLP."""

    def __init__(self, n_up, n_down, charges, n_atom_types, *, embedding_dim,
                 atom_type_embedding, subnet_type, edge_features, name: Optional[str] = None):
        super().__init__()
        if subnet_type not in ('mlp', 'embed'):
            raise ValueError(f'unknown subnet_type: {subnet_type!r}')
        n_nuc = len(charges)
        self.edge_features, self.out_dim = edge_features, embedding_dim
        if edge_features:
            self.edge_factory = MolecularGraphEdgeBuilder(n_nuc, n_up, n_down, ['nn'],
                                                          self_interaction=True)
            self.edge_mlp = _silu_mlp(len(edge_features) + n_nuc, 32, 'edge_mlp', 32)
            self.embed_mlp = _silu_mlp(32, embedding_dim, 'embed_mlp', embedding_dim)
            # [sender, receiver, n_nuc]: the sender's atom type
            charge = _one_hot_charges(charges, n_nuc)[:, None].expand(n_nuc, n_nuc, n_nuc)
            self.register_buffer('charge_embedding', charge.clone(), persistent=False)
        elif subnet_type == 'mlp':
            self.subnet = nn.MLP(1, embedding_dim, hidden_layers=['log', 1], bias=True,
                                 last_linear=False, activation=fl.tanh, init='deeperwin')
            token = (torch.as_tensor(charges, dtype=torch.float64) if atom_type_embedding
                     else torch.arange(n_nuc, dtype=torch.float64))
            self.register_buffer('input', token[:, None], persistent=False)
        else:
            self.subnet = nn.Embed(n_atom_types if atom_type_embedding else n_nuc, embedding_dim)
            ids = _atom_type_ids(charges) if atom_type_embedding else torch.arange(n_nuc)
            self.register_buffer('input', ids, persistent=False)

    def forward(self, R):
        """``R`` ``[B, n_nuc, 3]`` -> ``[B, n_nuc, embedding_dim]``."""
        if not self.edge_features:
            if isinstance(self.subnet, nn.Embed):
                return _batched(self.subnet(self.input), R)
            return self.subnet(_batched(self.input, R))
        feats = self.edge_features(self.edge_factory(None, R)['nn'].single_array)
        messages = self.edge_mlp(fl.cat([feats, _batched(self.charge_embedding, R)], -1))
        return self.embed_mlp(messages.sum(-3))


def _per_electron(x, n_el):
    """``featurize(single_array).swapaxes(0, 1).reshape(n_el, -1)`` per walker."""
    k = x.dim() - 1
    x = x.transpose(-k, -k + 1)
    return x.flatten(-k, -1).unflatten(-1, (n_el, -1))


class ElectronEmbedding(nn.Module):
    """Initial electron embeddings: per electron, the features of each
    positional edge type (flattened over the senders), the spin with
    ``use_spin``, projected to ``embedding_dim`` by a bias-free linear layer
    with ``project_to_embedding_dim``; without positional embeddings a
    table of electron types.  ``out_dim`` is the width it returns."""

    def __init__(self, n_nuc, n_up, n_down, embedding_dim, n_elec_types, elec_types, *,
                 positional_embeddings, use_spin, project_to_embedding_dim, nuclei_dim=None,
                 name: Optional[str] = None):
        super().__init__()
        self.n_el = n_up + n_down
        self.positional_embeddings = dict(positional_embeddings or {})
        self.use_spin = use_spin
        self.register_buffer('elec_types', torch.as_tensor(elec_types), persistent=False)
        self.register_buffer('spin', _spin_column(n_up, n_down), persistent=False)
        if not self.positional_embeddings:
            self.embed = nn.Embed(n_elec_types, embedding_dim, name='electronic_embedding')
            self.out_dim = embedding_dim
            return
        self.build_edges = MolecularGraphEdgeBuilder(
            n_nuc, n_up, n_down, list(self.positional_embeddings), self_interaction=False)
        in_dim = self._features(torch.zeros(1, self.n_el, 3, dtype=torch.float64),
                                torch.zeros(1, n_nuc, 3, dtype=torch.float64)).shape[-1]
        self.linear = (nn.Linear(in_dim, embedding_dim, with_bias=False)
                       if project_to_embedding_dim else None)
        self.out_dim = embedding_dim if project_to_embedding_dim else in_dim

    def _features(self, r, R):
        edges = self.build_edges(r, R)
        columns = [_per_electron(f(edges[t].single_array), self.n_el)
                   for t, f in self.positional_embeddings.items()]
        if self.use_spin:
            columns.append(_batched(self.spin, columns[0]))
        return columns[0] if len(columns) == 1 else fl.cat(columns, -1)

    def forward(self, r, R, nucleus_embedding=None):
        """``r`` ``[B, n_el, 3]`` (FL), ``R`` ``[B, n_nuc, 3]`` -> ``[B, n_el, out_dim]``."""
        if not self.positional_embeddings:
            return _batched(self.embed(self.elec_types), R)
        x = self._features(r, R)
        return self.linear(x) if self.linear is not None else x


class PermutationInvariantEmbedding(nn.Module):
    """Electron embeddings invariant to exchanges of identical nuclei: the
    sum over the nuclei of electron-nucleus messages that carry the nucleus's
    identity ('concatenate': an MLP of the edge features and the atom type
    or the nuclear embedding; 'elementwise-product': a sigmoid gate of the
    edge features times a linear map of the atom type), with the spin, through
    an MLP."""

    def __init__(self, n_nuc, n_up, n_down, embedding_dim, n_elec_types, elec_types, charges,
                 *, edge_dim, edge_features, nuclear_charge_dependence, use_spin,
                 nuclei_dim=None, name: Optional[str] = None):
        super().__init__()
        if nuclear_charge_dependence not in ('concatenate', 'elementwise-product'):
            raise ValueError(f'unknown nuclear_charge_dependence: {nuclear_charge_dependence!r}')
        self.n_up, self.n_down = n_up, n_down
        self.edge_factory = MolecularGraphEdgeBuilder(n_nuc, n_up, n_down, ['ne'],
                                                      self_interaction=False)
        self.edge_features = edge_features
        self.nuclear_charge_dependence = nuclear_charge_dependence
        self.use_spin = use_spin
        charge = _one_hot_charges(charges, len(charges))
        n_el = n_up + n_down
        if nuclear_charge_dependence == 'elementwise-product':
            self.charge_linear = nn.Linear(len(charges), edge_dim, name='edge_linear')
            self.edge_linear = nn.Linear(len(edge_features), edge_dim)
        else:
            charge = charge[:, None].expand(len(charges), n_el, len(charges))
            nuc = len(charges) if nuclei_dim is None else nuclei_dim
            self.edge_mlp = _silu_mlp(len(edge_features) + nuc, edge_dim, 'edge_mlp', edge_dim)
        self.register_buffer('charge_embedding', charge.clone(), persistent=False)
        self.register_buffer('spin', _spin_column(n_up, n_down), persistent=False)
        self.embed_mlp = _silu_mlp(edge_dim + use_spin, embedding_dim, 'embed_mlp', embedding_dim)
        self.out_dim = embedding_dim

    def _ne_messages(self, ne_features, nucleus_embedding):
        """Per (nucleus, electron) messages carrying the nuclear identity."""
        if self.nuclear_charge_dependence == 'elementwise-product':
            gate = fl.sigmoid(self.edge_linear(ne_features))
            charge = self.charge_linear(_batched(self.charge_embedding, ne_features))
            return gate * charge[..., None, :]
        n_el = ne_features.shape[-2]
        nuc = (_batched(self.charge_embedding, ne_features) if nucleus_embedding is None
               else fl.tile(nucleus_embedding[..., None, :], -2, n_el))
        return self.edge_mlp(fl.cat([ne_features, nuc], -1))

    def forward(self, r, R, nucleus_embedding=None):
        ne_features = self.edge_features(self.edge_factory(r, R)['ne'].single_array)
        pooled = self._ne_messages(ne_features, nucleus_embedding).sum(-3)
        if self.use_spin:
            pooled = fl.cat([pooled, _batched(self.spin, pooled)], -1)
        return self.embed_mlp(pooled)


def _spin_node_types(n_up, n_down):
    """Electron node-type metadata: one type, or up/down when asymmetric."""
    distinct = n_up != n_down
    return {
        'n_node_types': {'electrons': 2 if distinct else 1},
        'node_types': {'electrons': torch.tensor(n_up * [0] + n_down * [1 if distinct else 0])},
    }


class ElectronGNN(nn.Module):
    """The GNN over electrons and nuclei: the embeddings, the typed edges
    featurised by ``edge_features`` (type -> feature), ``n_interactions``
    layers from ``layer_factory``; ``ghost_coords`` adds chargeless nuclei.
    Returns the final :class:`~.utils.GraphNodes`; ``out_dims`` are their
    widths."""

    def __init__(self, hamil, embedding_dim, *, n_interactions, edge_features,
                 self_interaction, two_particle_stream_dim, nuclei_embedding,
                 electron_embedding, layer_factory, ghost_coords=None,
                 name: Optional[str] = None):
        super().__init__()
        n_up, n_down = hamil.n_up, hamil.n_down
        charges = [float(z) for z in hamil.mol.charges]
        ghosts = [] if ghost_coords is None else [list(map(float, c)) for c in ghost_coords]
        n_atom_types = len(set(charges)) + bool(ghosts)
        charges += [0.0] * len(ghosts)
        n_nuc = len(charges)
        self.register_buffer('ghost_coords', torch.tensor(ghosts, dtype=torch.float64)
                             .reshape(len(ghosts), 3), persistent=False)
        self.n_up, self.n_down = n_up, n_down
        self.edge_features = dict(edge_features or {})
        self.build_edges = MolecularGraphEdgeBuilder(
            n_nuc, n_up, n_down, list(self.edge_features), self_interaction=self_interaction)
        self.nuclei_embedding = (nuclei_embedding(n_up, n_down, charges, n_atom_types)
                                 if nuclei_embedding else None)
        types = _spin_node_types(n_up, n_down)
        nuclei_dim = self.nuclei_embedding.out_dim if self.nuclei_embedding else None
        self.electron_embedding = electron_embedding(
            n_nuc, n_up, n_down, embedding_dim, types['n_node_types']['electrons'],
            types['node_types']['electrons'], nuclei_dim=nuclei_dim)
        dims = {'electrons': self.electron_embedding.out_dim, 'nuclei': nuclei_dim,
                **{t: len(f) for t, f in self.edge_features.items()}}
        node_data = {'n_nodes': {'nuclei': n_nuc, 'electrons': n_up + n_down}, **types}
        layers = []
        for ilayer in range(n_interactions):
            layers.append(layer_factory(
                n_interactions, ilayer, n_nuc, n_up, n_down, embedding_dim,
                tuple(self.edge_features), self_interaction, {**node_data, 'dims': dims},
                two_particle_stream_dim))
            dims = {**dims, **layers[-1].out_dims}
        self.layers = torch.nn.ModuleList(layers)
        self.out_dims = GraphNodes(dims['nuclei'], dims['electrons'])
        self.embedding_dim = dims['electrons']

    def _nuclei(self, r, R):
        """The nuclear coordinates (with the ghosts) ``[B, n_nuc, 3]``."""
        x = fl.primal(r)
        R = R.to(dtype=x.dtype, device=x.device)
        if len(self.ghost_coords):
            ghosts = self.ghost_coords.to(R.dtype).expand(*R.shape[:-2], -1, 3)
            R = torch.cat([R, ghosts], -2)
        return R.expand(x.shape[0], *R.shape[-2:]) if R.dim() == 2 else R

    def edge_factory(self, r, R):
        """The typed edges, each featurised through its ``single_array``."""
        raw = self.build_edges(r, R)
        return {t: raw[t].update_from_single_array(f(raw[t].single_array))
                for t, f in self.edge_features.items()}

    def forward(self, r, R):
        R = self._nuclei(r, R)
        nuclei = self.nuclei_embedding(R) if self.nuclei_embedding else None
        nodes = GraphNodes(nuclei, self.electron_embedding(r, R, nuclei))
        edges = self.edge_factory(r, R)
        for layer in self.layers:
            nodes, edges = layer(nodes, edges)
        return nodes
