"""Update-feature options that no ported preset sets, against the JAX package.

The small ``default`` preset with its update features replaced, on both
sides alike, by per-spin node sums without normalisation, edge sums over
'same', 'anti' and 'ee' and a convolution over 'ee' (the 'same' and 'anti'
convolutions summed), with and without normalisation.  The Li atom (2 up,
1 down) has an empty down-down block, whose normalised sum divides by 1 in
both packages.  JAX's parameters converted; log|psi| to relative 1e-10, sign
exactly, and the local energy with its terms to relative 1e-9, at float64.
The options of the ``conf/ansatz`` trees are in ``test_torch_zoo_tree_options.py``.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch
from torch_parity import jax_model, jax_phys_conf, jit_once, torch_model, torch_phys_conf, walkers

import deepqmc_tpu.gnn.update_features as jax_uf
import deepqmc_tpu.presets as jax_presets
import deepqmc_tpu_torch.gnn.update_features as torch_uf
import deepqmc_tpu_torch.presets as torch_presets

PSI_RTOL, ELOC_RTOL = 1e-10, 1e-9
TERMS = ('E_kin', 'V_loc', 'V_el', 'lap', 'quantum_force')


def _features(uf, normalize, subnet):
    return [
        uf.ResidualElectronUpdateFeature,
        partial(uf.NodeSumElectronUpdateFeature, node_types=['up', 'down'], normalize=False),
        partial(uf.EdgeSumElectronUpdateFeature, edge_types=['same', 'anti', 'ee'],
                normalize=normalize),
        partial(uf.ConvolutionElectronUpdateFeature, edge_types=['ee'], normalize=normalize,
                w_factory=subnet, h_factory=subnet),
    ]


def _layer_with_features(layer_cls, uf, normalize):
    """``layer_cls`` with the preset's update features replaced; the
    convolution's nets come from the preset's subnet factory."""

    def layer(*args, update_features, subnet_factory, **kwargs):
        return layer_cls(*args, update_features=_features(uf, normalize, subnet_factory),
                         subnet_factory=subnet_factory, **kwargs)

    return layer


@pytest.fixture(scope='module', params=[('Li', True), ('LiH', False)],
                ids=lambda p: f'{p[0]}-normalize{p[1]}')
def case(request):
    mol, normalize = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_presets, 'ElectronGNNLayer', _layer_with_features(
            jax_presets.ElectronGNNLayer, jax_uf, normalize))
        mp.setattr(torch_presets, 'ElectronGNNLayer', _layer_with_features(
            torch_presets.ElectronGNNLayer, torch_uf, normalize))
        hamil_j, ansatz, params = jax_model(mol, seed=1, preset='default')
        hamil_t, wf = torch_model(mol, params, preset='default')
        r = walkers(hamil_j, 'init_sample', n=2, seed=3)
        pc = jax_phys_conf(hamil_j, r)
        psi = jit_once(jax.vmap(ansatz.apply, (None, 0)))(params, pc)
        eloc, stats = jit_once(jax.vmap(hamil_j.local_energy(ansatz.apply), (None, None, 0)))(
            None, params, pc)
    want = {'E_loc': np.asarray(eloc), **{k: np.asarray(stats[f'hamil/{k}']) for k in TERMS}}
    return hamil_t, wf, r, psi, want


def test_options_change_the_network(case):
    """The replaced features are the ones built: three edge sums and the
    'ee' convolution's four nets in every layer, the sums as wide as the
    edges the layer receives (the raw features, then the stream's width)."""
    _, wf, *_ = case
    for layer, edge_dim in zip(wf.omni.gnn.layers, (4, 8)):
        kinds = [type(uf).__name__ for uf in layer.update_features]
        assert kinds == ['ResidualElectronUpdateFeature', 'NodeSumElectronUpdateFeature',
                         'EdgeSumElectronUpdateFeature', 'ConvolutionElectronUpdateFeature']
        assert layer.update_features[2].widths == [edge_dim] * 3
        assert sorted(layer.update_features[3].nets) == ['h_anti', 'h_same', 'w_anti', 'w_same']


def test_psi_with_options_matches_jax(case):
    hamil, wf, r, want, _ = case
    with torch.inference_mode():
        got = wf(torch_phys_conf(hamil, r))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.log.numpy(), np.asarray(want.log), rtol=PSI_RTOL)


def test_local_energy_with_options_matches_jax(case):
    hamil, wf, r, _, want = case
    with torch.inference_mode():
        eloc, stats = hamil.local_energy(wf, torch_phys_conf(hamil, r))
    got = {'E_loc': eloc.numpy(), **{k: stats[f'hamil/{k}'].numpy() for k in TERMS}}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=ELOC_RTOL, err_msg=key)

