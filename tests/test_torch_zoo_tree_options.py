"""Options of the ``conf/ansatz`` trees that no preset sets, against the JAX
package.

Each tree composed with the same overrides by both packages' config layers
and built by them (the port's tree reader, ``presets.ansatz_from_config``):
the update rules 'sum', 'featurewise_shared' and 'featurewise'; explicit MLP
widths with ``bias='not_last'``; every switch of ``ExponentialEnvelopes``
off its preset's value; ``backflow_transform`` 'add' and 'both' (the latter
with ``BackflowOp``'s own ``mult_act`` and without the envelope scale); no
``omni_factory``; and, with ``ElectronGNN`` patched alike in both packages,
DeepErwin with the 'nn' and 'en' edges besides its 'ne' edges, Gaussian edge
features and negative distance powers with ``eps``, the electron embedding
reading the 'en' edges too, and 'ne' in an edge sum and in a convolution
with ``w`` (the backflow, no-omni and edge cases run in
``test_torch_zoo_tree_backflow_edges.py``).  Small widths (2 determinants,
embedding 16, 2 interactions) on LiH, JAX's parameters (perturbed by seeded
noise) converted; log|psi| to relative 1e-10, sign exactly, and the local
energy with its terms to relative 1e-9, at float64.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch
from torch_parity import init_sample, jax_phys_conf, jit_once, torch_phys_conf, walkers

PSI_RTOL, ELOC_RTOL = 1e-10, 1e-9
TERMS = ('E_kin', 'V_loc', 'V_el', 'lap', 'quantum_force')


# --- options of the ansatz trees, built by both packages' config layers ----

SMALL_TREE = ['hamil/mol=LiH', 'ansatz.n_determinants=2', 'ansatz.omni_factory.embedding_dim=16',
              'ansatz.omni_factory.gnn_factory.n_interactions=2']
LAYER = 'ansatz.omni_factory.gnn_factory.layer_factory'
WIDE_STREAM = ['ansatz.omni_factory.gnn_factory.two_particle_stream_dim=16',
               'ansatz.omni_factory.gnn_factory.electron_embedding.project_to_embedding_dim=true']
NARROW_STREAM = ['ansatz.omni_factory.gnn_factory.two_particle_stream_dim=8']
TREE_CASES = {
    # the update rules: messages summed, one net over the stacked messages,
    # one net per message ('sum' and 'featurewise_shared' want one width)
    'update-sum': ['ansatz=default', *WIDE_STREAM, f'{LAYER}.update_rule=sum'],
    'update-featurewise-shared': ['ansatz=default', *WIDE_STREAM,
                                  f'{LAYER}.update_rule=featurewise_shared'],
    'update-featurewise': ['ansatz=default', *NARROW_STREAM, f'{LAYER}.update_rule=featurewise'],
    'mlp-widths-not-last-backflow-add': [
        'ansatz=ferminet', *NARROW_STREAM, f'{LAYER}.subnet_factory.hidden_layers=[12, 6]',
        f'{LAYER}.subnet_factory.bias=not_last', 'ansatz.backflow_transform=add'],
    # each switch of the exponential envelopes off its preset's value
    'envelope-anisotropic-shared-exponent-per-shell': [
        'ansatz=ferminet', *NARROW_STREAM, 'ansatz.envelope.isotropic=false',
        'ansatz.envelope.per_orbital_exponent=false', 'ansatz.envelope.per_shell=true'],
    'envelope-spin-restricted-drawn-softplus': [
        'ansatz=ferminet', *NARROW_STREAM, 'ansatz.envelope.spin_restricted=true',
        'ansatz.envelope.init_to_ones=false', 'ansatz.envelope.softplus_zeta=true'],
    # both transforms with BackflowOp's own mult_act and no envelope scale
    'backflow-both-default-act-no-envelope': [
        'ansatz=default', *NARROW_STREAM, 'ansatz.backflow_transform=both',
        '~ansatz.backflow_op.mult_act', '+ansatz.backflow_op.with_envelope=false'],
    # no GNN at all: the envelopes are the orbitals
    'no-omni': ['ansatz=ferminet', 'ansatz.omni_factory=null'],
}


def _jax_tree(overrides):
    """(JAX hamiltonian, ansatz, noisy params, walkers, psi, E_loc and terms)."""
    from deepqmc_tpu import config as jax_config
    from deepqmc_tpu.wf import instantiate_ansatz

    cfg = jax_config.compose(overrides=overrides, user_conf_dir=None)
    hamil = jax_config.instantiate(cfg['hamil'], root=cfg)
    ansatz = instantiate_ansatz(hamil, jax_config.instantiate(cfg['ansatz'], root=cfg))
    pc = init_sample(hamil, 1, 0)[0]
    params = jit_once(ansatz.init)(jax.random.PRNGKey(1), pc)
    noise = np.random.default_rng(2)
    params = {path: {k: np.asarray(v) + 0.1 * noise.normal(size=np.shape(v))
                     for k, v in bundle.items()} for path, bundle in params.items()}
    r = walkers(hamil, 'init_sample', n=2, seed=3)
    pcs = jax_phys_conf(hamil, r)
    psi = jit_once(jax.vmap(ansatz.apply, (None, 0)))(params, pcs)
    eloc, stats = jit_once(jax.vmap(hamil.local_energy(ansatz.apply), (None, None, 0)))(
        None, params, pcs)
    want = {'E_loc': np.asarray(eloc), **{k: np.asarray(stats[f'hamil/{k}']) for k in TERMS}}
    return params, r, psi, want


def _port_tree(overrides, params):
    from deepqmc_tpu_torch import config
    from deepqmc_tpu_torch.convert import state_dict_from_jax

    cfg = config.compose(overrides=overrides)
    hamil = config.instantiate(cfg['hamil'], root=cfg)
    wf = config.instantiate(cfg['ansatz'], root=cfg)(hamil).to(torch.float64)
    wf.load_state_dict(state_dict_from_jax(params, wf))
    return hamil, wf


def _edge_features(ef, log_rescale=False):
    """Edge features no preset sets: negative powers with eps, Gaussians."""
    gaussians = ef.GaussianEdgeFeature(n_gaussian=3, radius=3.0, offset=True)
    return {
        'ne': ef.CombinedEdgeFeature(features=[ef.DistancePowerEdgeFeature(powers=[1]),
                                               ef.DifferenceEdgeFeature()]),
        'same': ef.CombinedEdgeFeature(features=[
            ef.DistancePowerEdgeFeature(powers=[1, -1], eps=0.1), gaussians]),
        'anti': ef.CombinedEdgeFeature(features=[
            ef.DistancePowerEdgeFeature(powers=[2, -2], eps=0.5, log_rescale=True), gaussians]),
        'nn': ef.GaussianEdgeFeature(n_gaussian=5, radius=4.0, offset=False),
        'en': ef.DistancePowerEdgeFeature(powers=[1, -1, 0.5, -3], eps=0.2),
    }


def _gnn_with_edges(gnn_cls, ef, uf):
    """``gnn_cls`` with the edge types 'nn' and 'en' besides DeepErwin's, the
    electron embedding reading the 'en' edges too, and the layers' update
    features with 'ne' in an edge sum and in a convolution with ``w``."""

    def gnn(*args, edge_features, electron_embedding, layer_factory, **kwargs):
        positional = {**electron_embedding.keywords['positional_embeddings'],
                      'en': ef.GaussianEdgeFeature(n_gaussian=2, radius=2.0, offset=True)}
        features = layer_factory.keywords['update_features']
        subnet = layer_factory.keywords['subnet_factory']
        features = [*features,
                    partial(uf.EdgeSumElectronUpdateFeature, edge_types=['ne', 'ee'],
                            normalize=True),
                    partial(uf.ConvolutionElectronUpdateFeature, edge_types=['ne'],
                            normalize=True, w_factory=subnet, h_factory=subnet)]
        return gnn_cls(*args, edge_features=_edge_features(ef),
                       electron_embedding=partial(electron_embedding,
                                                  positional_embeddings=positional),
                       layer_factory=partial(layer_factory, update_features=features),
                       **kwargs)

    return gnn


EDGE_CASE = ['ansatz=deeperwin', *NARROW_STREAM]


EDGES = 'edges-nn-en-ne-gaussian-negative-powers'
# the cases of this file; the others run in test_torch_zoo_tree_backflow_edges.py
HERE = ['update-sum', 'update-featurewise-shared', 'update-featurewise',
        'envelope-anisotropic-shared-exponent-per-shell',
        'envelope-spin-restricted-drawn-softplus']


def make_tree_case(name):
    """(port hamiltonian and ansatz, walkers, JAX's psi, E_loc and terms) of a case."""
    if name in TREE_CASES:
        overrides = [*SMALL_TREE, *TREE_CASES[name]]
        params, r, psi, want = _jax_tree(overrides)
        return _port_tree(overrides, params), r, psi, want
    import deepqmc_tpu.gnn as jax_gnn
    import deepqmc_tpu.gnn.edge_features as jax_ef
    import deepqmc_tpu.gnn.update_features as jax_uf
    import deepqmc_tpu_torch.gnn as torch_gnn
    import deepqmc_tpu_torch.gnn.edge_features as torch_ef
    import deepqmc_tpu_torch.gnn.update_features as torch_uf

    overrides = [*EDGE_CASE, *SMALL_TREE]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gnn, 'ElectronGNN', _gnn_with_edges(jax_gnn.ElectronGNN, jax_ef, jax_uf))
        mp.setattr(torch_gnn, 'ElectronGNN',
                   _gnn_with_edges(torch_gnn.ElectronGNN, torch_ef, torch_uf))
        params, r, psi, want = _jax_tree(overrides)
        port = _port_tree(overrides, params)
    edges = port[1].omni.gnn.edge_features
    assert sorted(edges) == ['anti', 'en', 'ne', 'nn', 'same']
    layers = port[1].omni.gnn.layers
    assert 'en' in layers[0].u and layers[1].u is None
    assert 'w_ne' in layers[0].update_features[4].nets  # the 'ne' convolution with w
    assert layers[0].update_features[3].widths == [4, 5]  # 'ne' and 'ee' edge sums
    return port, r, psi, want


@pytest.fixture(scope='module', params=HERE)
def tree_case(request):
    return make_tree_case(request.param)


def test_tree_options_psi_matches_jax(tree_case):
    (hamil, wf), r, want, _ = tree_case
    with torch.inference_mode():
        got = wf(torch_phys_conf(hamil, r))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.log.numpy(), np.asarray(want.log), rtol=PSI_RTOL)


def test_tree_options_local_energy_matches_jax(tree_case):
    (hamil, wf), r, _, want = tree_case
    with torch.inference_mode():
        eloc, stats = hamil.local_energy(wf, torch_phys_conf(hamil, r))
    got = {'E_loc': eloc.numpy(), **{k: stats[f'hamil/{k}'].numpy() for k in TERMS}}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=ELOC_RTOL, err_msg=key)
