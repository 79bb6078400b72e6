"""Typed all-pairs edges of the molecular graph (counterpart of
``deepqmc_tpu/gnn/graph.py``), walker-batched.

An edge block is ``[B, n_sender, n_receiver, feat]``, senders on axis -3 as in
the JAX package, a tensor or an :class:`~deepqmc_tpu_torch.fwdlap.FL`.  An
edge is the receiver's position minus the sender's, formed by one subtraction
of the electron FL from itself: a kept self-edge (FermiNet's ``up``/``down``)
then has a Jacobian of exactly 0.  The nuclei are constants: 'nn' edges are
plain tensors, 'ne' and 'en' edges FLs when the electrons are.  Self-edges
are removed structurally: the sender axis of a masked block has n - 1
entries, gathered by :func:`offdiagonal_sender_idx`.

``single_array`` is what the edge networks see: the block itself for the
simple containers, both blocks flattened to ``[B, n_edges, feat]`` and
concatenated for ``same`` and ``anti``.
"""

import math

import torch

from .. import fwdlap as fl

__all__ = [
    'AntiGraphEdges', 'DownGraphEdges', 'MolecularGraphEdgeBuilder', 'SameGraphEdges',
    'SimpleGraphEdges', 'UpGraphEdges', 'compute_edges', 'offdiagonal_sender_idx',
]


def offdiagonal_sender_idx(n_node: int, device=None) -> torch.Tensor:
    """[n-1, n] sender indices such that column r holds every node but r."""
    senders = torch.arange(n_node - 1, device=device)[:, None]
    receivers = torch.arange(n_node, device=device)[None, :]
    return (receivers <= senders).long() + senders


def compute_edges(pos_sender, pos_receiver, filter_diagonal: bool):
    """Receiver minus sender ``[B, n_s, n_r, 3]``."""
    diffs = fl.add(pos_receiver[..., None, :, :], fl.neg(pos_sender[..., :, None, :]))
    if filter_diagonal:
        n_node = pos_sender.shape[-2]
        device = fl.primal(pos_receiver).device
        receivers = torch.arange(n_node, device=device).expand(n_node - 1, n_node)
        diffs = diffs[..., offdiagonal_sender_idx(n_node, device), receivers, :]
    return diffs


def _reduce_senders(x, normalize: bool):
    return x.mean(-3) if normalize else x.sum(-3)


def _flat(x):
    return x.flatten(-3, -2)


class SimpleGraphEdges:
    """One block ``edges`` ``[B, n_s, n_r, feat]``."""

    def __init__(self, edges):
        self.edges = edges

    def leaves(self):
        return [self.edges]

    def from_leaves(self, leaves):
        return type(self)(*leaves)

    @property
    def single_array(self):
        return self.edges

    def update_from_single_array(self, array):
        return type(self)(array)

    def sum_senders(self, normalize=False):
        return _reduce_senders(self.edges, normalize)

    def _senders(self, nodes):
        return nodes[..., :, None, :]

    def convolve(self, nodes, normalize=False):
        """Each edge times its sender's node features, reduced over the senders."""
        return type(self)(self.edges * self._senders(nodes)).sum_senders(normalize)


class UpGraphEdges(SimpleGraphEdges):
    def _senders(self, nodes):
        return nodes[..., : self.edges.shape[-3], None, :]


class DownGraphEdges(SimpleGraphEdges):
    def _senders(self, nodes):
        n_el = nodes.shape[-2]
        return nodes[..., n_el - self.edges.shape[-3] :, None, :]


def _split_blocks(array, first, second):
    """``[B, n1 + n2, feat]`` -> blocks of the sender x receiver shapes ``first``, ``second``."""
    n = math.prod(first)
    return (array[..., :n, :].unflatten(-2, first), array[..., n:, :].unflatten(-2, second))


def _sum_blocks(blocks, normalize):
    """Per-receiver sums (means with ``normalize``; an empty block divides by 1)."""
    out = []
    for x in blocks:
        total = x.sum(-3)
        out.append(total / max(x.shape[-3], 1) if normalize else total)
    return fl.cat(out, -2)


class SameGraphEdges:
    """Same-spin blocks ``uu`` ``[B, s_up, n_up, feat]`` and ``dd``; without
    self-interaction s = n - 1 (off-diagonal senders)."""

    def __init__(self, uu, dd):
        self.uu, self.dd = uu, dd

    def leaves(self):
        return [self.uu, self.dd]

    def from_leaves(self, leaves):
        return type(self)(*leaves)

    @property
    def single_array(self):
        return fl.cat([_flat(self.uu), _flat(self.dd)], -2)

    def update_from_single_array(self, array):
        return type(self)(*_split_blocks(array, self.uu.shape[-3:-1], self.dd.shape[-3:-1]))

    def sum_senders(self, normalize=False):
        return _sum_blocks((self.uu, self.dd), normalize)

    def convolve(self, nodes, normalize=False):
        n_up, n_down = self.uu.shape[-2], self.dd.shape[-2]
        if self.uu.shape[-3] == n_up:  # self-interaction: every node sends
            up, down = nodes[..., :n_up, None, :], nodes[..., n_up:, None, :]
        else:
            device = fl.primal(nodes).device
            up = nodes[..., offdiagonal_sender_idx(n_up, device), :]
            down = nodes[..., n_up + offdiagonal_sender_idx(n_down, device), :]
        return type(self)(self.uu * up, self.dd * down).sum_senders(normalize)


class AntiGraphEdges:
    """Opposite-spin blocks ``du`` (down senders, up receivers) ``[B, n_down,
    n_up, feat]`` and ``ud`` ``[B, n_up, n_down, feat]``."""

    def __init__(self, du, ud):
        self.du, self.ud = du, ud

    def leaves(self):
        return [self.du, self.ud]

    def from_leaves(self, leaves):
        return type(self)(*leaves)

    @property
    def single_array(self):
        return fl.cat([_flat(self.du), _flat(self.ud)], -2)

    def update_from_single_array(self, array):
        return type(self)(*_split_blocks(array, self.du.shape[-3:-1], self.ud.shape[-3:-1]))

    def sum_senders(self, normalize=False):
        return _sum_blocks((self.du, self.ud), normalize)

    def convolve(self, nodes, normalize=False):
        n_up = self.du.shape[-2]
        du = self.du * nodes[..., n_up:, None, :]
        ud = self.ud * nodes[..., :n_up, None, :]
        return type(self)(du, ud).sum_senders(normalize)


def MolecularGraphEdgeBuilder(n_nuc, n_up, n_down, edge_types, *, self_interaction):
    """``(r [B, n_el, 3], R [B, n_nuc, 3]) -> {type: edges}`` for the types
    'nn', 'ne', 'en', 'same', 'anti', 'up' and 'down'.  'nn' and same-spin
    blocks lose their self-edges unless ``self_interaction``; the others keep
    every pair."""
    masked = not self_interaction
    build_rules = {
        'nn': lambda r, R: SimpleGraphEdges(compute_edges(R, R, masked)),
        'ne': lambda r, R: SimpleGraphEdges(compute_edges(R, r, False)),
        'en': lambda r, R: SimpleGraphEdges(compute_edges(r, R, False)),
        'same': lambda r, R: SameGraphEdges(
            compute_edges(r[..., :n_up, :], r[..., :n_up, :], masked),
            compute_edges(r[..., n_up:, :], r[..., n_up:, :], masked),
        ),
        'anti': lambda r, R: AntiGraphEdges(
            compute_edges(r[..., n_up:, :], r[..., :n_up, :], False),
            compute_edges(r[..., :n_up, :], r[..., n_up:, :], False),
        ),
        'up': lambda r, R: UpGraphEdges(compute_edges(r[..., :n_up, :], r, False)),
        'down': lambda r, R: DownGraphEdges(compute_edges(r[..., n_up:, :], r, False)),
    }
    unknown = set(edge_types) - set(build_rules)
    if unknown:
        raise ValueError(f'unknown edge types {sorted(unknown)}')

    def build(r, R=None):
        if r is not None and r.shape[-2] != n_up + n_down:
            raise ValueError(f'{r.shape[-2]} electrons, want {n_up + n_down}')
        if R is not None and R.shape[-2] != n_nuc:
            raise ValueError(f'{R.shape[-2]} nuclei, want {n_nuc}')
        return {typ: build_rules[typ](r, R) for typ in edge_types}

    return build
