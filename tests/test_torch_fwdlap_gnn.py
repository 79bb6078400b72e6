"""The forward-Laplacian rules that the FermiNet and ``default`` ansätze add,
against nested autograd.

Small functions of a seeded electron configuration ``[B, 3, 3]`` (2 up, 1
down) built from ``fwdlap`` ops and the edge containers of ``gnn.graph``:
means and tiles along a feature axis, gathers on two feature axes (the
off-diagonal senders), concatenation of edge blocks along the sender axis,
the per-type sums and convolutions, and self-edges (d = 0) through
``norm_safe`` and the edge features.  Each output goes through tanh and is
summed; the value, gradient and Laplacian from ``FL.seed`` are compared with
``torch.func`` at float64, relative tolerance 1e-12 (a few chained ops).
"""

import numpy as np
import pytest
import torch

from deepqmc_tpu_torch import fwdlap as fl
from deepqmc_tpu_torch.gnn import graph
from deepqmc_tpu_torch.gnn.edge_features import (
    CombinedEdgeFeature,
    DifferenceEdgeFeature,
    DistancePowerEdgeFeature,
)
from deepqmc_tpu_torch.physics import norm_safe

RTOL = 1e-12
N_UP, N_EL = 2, 3
W = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 4)))
U = torch.as_tensor(np.random.default_rng(1).normal(size=(4, 3)))
FEATURES = CombinedEdgeFeature(features=[DistancePowerEdgeFeature(powers=[1]),
                                         DifferenceEdgeFeature()])


def _edges(x, types, self_interaction):
    return graph.MolecularGraphEdgeBuilder(0, N_UP, N_EL - N_UP, types,
                                           self_interaction=self_interaction)(x)


def _nodes(x):
    return fl.tanh(x @ W)  # [B, n_el, 4]


def _same_anti_convolve(x):
    edges = _edges(x, ['same', 'anti'], False)
    nodes = _nodes(x)
    out = []
    for e in edges.values():
        feats = e.update_from_single_array(FEATURES(e.single_array))
        out += [feats.convolve(nodes), feats.sum_senders(normalize=True)]
    return fl.cat(out, -1)


def _same_self_interaction_convolve(x):
    same = _edges(x, ['same'], True)['same']
    feats = same.update_from_single_array(FEATURES(same.single_array))
    return feats.convolve(_nodes(x), normalize=True)


def _up_down_shared_stream(x):
    """FermiNet's edges: up and down blocks with their self-edges,
    concatenated along the senders, through a net, split back, summed."""
    edges = _edges(x, ['up', 'down'], True)
    arrays = [FEATURES(e.single_array) for e in edges.values()]
    fused = fl.tanh(fl.cat(arrays, -3) @ U)
    up = edges['up'].update_from_single_array(fused[..., :N_UP, :, :])
    down = edges['down'].update_from_single_array(fused[..., N_UP:, :, :])
    return fl.cat([up.sum_senders(True), down.sum_senders(True), up.convolve(_nodes(x)[..., :3]),
                   down.convolve(_nodes(x)[..., :3])], -1)


FUNCTIONS = {
    'mean_tile': lambda x: fl.tile((x * x).mean(-2, keepdim=True), -2, N_EL) * x,
    'offdiagonal_gather': lambda x: graph.compute_edges(x, x, True) * x[..., None, :, :],
    'node_gather': lambda x: _nodes(x)[..., graph.offdiagonal_sender_idx(N_EL), :],
    'self_edge_norm': lambda x: norm_safe(graph.compute_edges(x, x, False)),
    'self_edge_features': lambda x: FEATURES(graph.compute_edges(x, x, False)),
    'cat_senders': lambda x: fl.cat([graph.compute_edges(x[..., :N_UP, :], x, False),
                                     graph.compute_edges(x[..., N_UP:, :], x, False)], -3),
    'same_anti_convolve': _same_anti_convolve,
    'same_self_interaction_convolve': _same_self_interaction_convolve,
    'up_down_shared_stream': _up_down_shared_stream,
}


@pytest.mark.parametrize('name', sorted(FUNCTIONS))
def test_rule_matches_autograd(name):
    f = FUNCTIONS[name]
    x0 = torch.as_tensor(np.random.default_rng(2).normal(size=(2, N_EL, 3)))

    def scalar(x):
        y = fl.tanh(f(x))
        while y.dim() > 1:
            y = y.sum(-1)
        return y

    with torch.inference_mode():
        out = scalar(fl.FL.seed(x0))
    for b in range(x0.shape[0]):
        def one(xb):
            return scalar(xb.reshape(1, N_EL, 3))[0]

        flat = x0[b].reshape(-1)
        grad = torch.func.grad(one)(flat)
        lap = torch.func.hessian(one)(flat).diagonal().sum()
        torch.testing.assert_close(out.jac[b], grad, rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(out.lap[b], lap, rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(out.x[b], one(flat), rtol=RTOL, atol=RTOL)


def test_self_edges_have_zero_derivatives():
    """A kept self-edge (FermiNet's up and down blocks) is the electron FL
    minus itself: its Jacobian and Laplacian are exactly 0, and its length
    is sqrt(eps) with finite, zero derivatives."""
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(2, N_EL, 3)))
    with torch.inference_mode():
        d = graph.compute_edges(fl.FL.seed(x), fl.FL.seed(x), False)
        r = norm_safe(_edges(fl.FL.seed(x), ['up'], True)['up'].edges)
    diag = torch.arange(N_EL)
    assert torch.equal(d.x[:, diag, diag], torch.zeros(2, N_EL, 3, dtype=x.dtype))
    assert not d.jac[:, :, diag, diag].any() and not d.lap[:, diag, diag].any()
    up = torch.arange(N_UP)
    eps = torch.finfo(x.dtype).eps
    torch.testing.assert_close(r.x[:, up, up], torch.full((2, N_UP), eps**0.5, dtype=x.dtype))
    assert not r.jac[:, :, up, up].any() and not r.lap[:, up, up].any()
    assert torch.isfinite(r.jac).all() and torch.isfinite(r.lap).all()


def test_same_edges_drop_the_diagonal():
    """Without self-interaction the sender axis has n - 1 entries: column r
    holds every other electron of the spin, in order."""
    np.testing.assert_array_equal(graph.offdiagonal_sender_idx(3).numpy(),
                                  [[1, 0, 0], [2, 2, 1]])
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(1, N_EL, 3)))
    same = _edges(x, ['same'], False)['same']
    assert same.uu.shape == (1, 1, 2, 3) and same.dd.shape == (1, 0, 1, 3)
    torch.testing.assert_close(same.uu[0, 0], torch.stack([x[0, 0] - x[0, 1], x[0, 1] - x[0, 0]]),
                               rtol=0, atol=0)
    assert same.single_array.shape == (1, 2, 3)
    assert same.sum_senders(normalize=True).shape == (1, N_EL, 3)
