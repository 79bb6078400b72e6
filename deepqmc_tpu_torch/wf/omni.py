"""OmniNet (counterpart of ``deepqmc_tpu/wf/omni.py``): the GNN's electron
embeddings feed an optional Jastrow factor and the backflow heads of each
spin, its nuclear embeddings an optional head of per-nucleus envelope
parameters.

Each class takes the JAX class's arguments after the width of the
embeddings it reads, which the JAX class learns at its first call."""

import math
from typing import Optional

import torch

from .. import fwdlap as fl
from .. import nn
from ..nn.core import constant_init

__all__ = ['Backflow', 'Jastrow', 'NuclearGNNHead', 'OmniNet']


class Jastrow(nn.Module):
    """Deep Jastrow factor ``[B]`` from the embeddings: with ``sum_first`` the
    embeddings are summed over the electrons before the net ``subnet_factory(
    in_dim, 1)``, else its outputs are."""

    def __init__(self, in_dim, *, sum_first, subnet_factory, name: Optional[str] = None):
        super().__init__()
        self.net = subnet_factory(in_dim, 1)
        self.sum_first = sum_first

    def forward(self, xs):
        out = self.net(xs.sum(-2)) if self.sum_first else self.net(xs).sum(-2)
        return out.squeeze(-1)


class Backflow(nn.Module):
    """Backflow factors ``[B, n_backflows, n_el, n_det * n_orbitals]`` (det-major
    columns) from the embeddings: one net per backflow with ``multi_head``,
    else one net for all."""

    def __init__(self, in_dim, n_orbitals, n_determinants, n_backflows, spin, multi_head=True,
                 *, subnet_factory, name: Optional[str] = None):
        super().__init__()
        self.width = n_orbitals * n_determinants
        self.multi_head = multi_head
        if multi_head:
            self.nets = torch.nn.ModuleList(
                subnet_factory(in_dim, self.width) for _ in range(n_backflows))
        else:
            self.net = subnet_factory(in_dim, n_backflows * self.width)

    def forward(self, xs):
        if self.multi_head:
            outs = [net(xs)[..., None, :, :] for net in self.nets]
            return outs[0] if len(outs) == 1 else fl.cat(outs, -3)
        return self.net(xs).unflatten(-1, (-1, self.width)).transpose(-2, -3)


class NuclearGNNHead(nn.Module):
    """Per-nucleus parameters ``{'{key}_{spin}': [B, n_nuc, *shape]}`` for each
    ``key: shape`` of ``one_particle_parameters``: a GLU readout of the
    nuclear embeddings (one per key, the spins sharing it, as the JAX
    package's module of one name) plus a bias per spin, started at 2."""

    def __init__(self, in_dim, n_nuc, *, one_particle_parameters, name: Optional[str] = None):
        super().__init__()
        self.shapes = {k: tuple(shape) for k, shape in one_particle_parameters.items()}
        self.glus = torch.nn.ModuleDict({
            k: nn.GLU(in_dim, math.prod(shape), name=f'{k}_readout_glu')
            for k, shape in self.shapes.items()})
        for k, shape in self.shapes.items():
            for spin in ('up', 'down'):
                setattr(self, f'{k}_bias_{spin}',
                        torch.nn.Parameter(constant_init(2.0)(None, (n_nuc, *shape))))

    def forward(self, nucleus_embeddings):
        out = {}
        for k, shape in self.shapes.items():
            glu = self.glus[k](nucleus_embeddings, nucleus_embeddings).unflatten(-1, shape)
            for spin in ('up', 'down'):
                out[f'{k}_{spin}'] = glu + getattr(self, f'{k}_bias_{spin}')
        return out


class OmniNet(nn.Module):
    """Runs the GNN once and feeds its embeddings to the Jastrow, backflow
    and nuclear heads.  ``n_orb_up``/``n_orb_down`` are the spin electron
    counts, or the electron count for full determinants."""

    def __init__(self, hamil, n_orb_up, n_orb_down, n_determinants, n_backflows, *,
                 embedding_dim, gnn_factory, jastrow_factory, backflow_factory,
                 nuclear_gnn_head=None, name: Optional[str] = None):
        super().__init__()
        self.n_up = hamil.n_up
        self.gnn = gnn_factory(hamil, embedding_dim) if gnn_factory else None
        dims = self.gnn.out_dims if self.gnn is not None else None
        self.jastrow = jastrow_factory(dims.electrons) if jastrow_factory and dims else None
        self.backflow = None
        if backflow_factory and dims:
            self.backflow = torch.nn.ModuleDict({
                spin: backflow_factory(dims.electrons, n_orb, n_determinants, n_backflows, spin)
                for spin, n_orb in (('up', n_orb_up), ('down', n_orb_down))})
        self.nuclear_gnn_head = None
        if nuclear_gnn_head and dims:
            if dims.nuclei is None:
                raise ValueError('a nuclear GNN head needs nuclear embeddings: the GNN has no '
                                 'nuclei_embedding')
            n_nuc = len(self.gnn.ghost_coords) + hamil.n_nuc
            self.nuclear_gnn_head = nuclear_gnn_head(dims.nuclei, n_nuc)

    def forward(self, r, R):
        """(Jastrow ``[B]`` or None, backflow factors of each spin ``([B, n_bf,
        n_up, D*n_orb_up], [B, n_bf, n_down, D*n_orb_down])`` or None, the
        nuclear head's parameters or None)."""
        if self.gnn is None:
            return None, None, None
        nodes = self.gnn(r, R)
        h = nodes.electrons
        nuc_params = (self.nuclear_gnn_head(nodes.nuclei)
                      if self.nuclear_gnn_head is not None else None)
        jastrow = self.jastrow(h) if self.jastrow is not None else None
        backflow = None
        if self.backflow is not None:
            backflow = (self.backflow['up'](h[..., : self.n_up, :]),
                        self.backflow['down'](h[..., self.n_up :, :]))
        return jastrow, backflow, nuc_params
