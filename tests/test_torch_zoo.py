"""The port's FermiNet and PauliNet-style ``default`` ansätze against the JAX
package.

The small presets (2 determinants, embedding 16, 2 interactions, two-particle
width 8) with full and per-spin determinants on H2, LiH, H2O and the
open-shell Li atom (2 up, 1 down), with JAX's parameters converted by
``deepqmc_tpu_torch.convert``; walkers from JAX ``init_sample`` and, for LiH,
the pinned self-golden walker (FermiNet's cases run in
``test_torch_zoo_ferminet.py``); the small PsiFormer with per-spin
determinants too.  Sign exactly, log|psi| to relative 1e-10 at float64.
Also: the conversion covers every parameter both ways, the
initial weights have the spread of JAX's initialisers, and the presets
refuse what they cannot build.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch_parity import (
    init_sample,
    jax_model,
    jax_phys_conf,
    jit_once,
    molecule,
    small_kwargs,
    torch_model,
    torch_phys_conf,
    walkers,
)

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt
from deepqmc_tpu.presets import ansatz_preset as jax_ansatz_preset
from deepqmc_tpu.wf import instantiate_ansatz
from deepqmc_tpu_torch.convert import state_dict_from_jax
from deepqmc_tpu_torch.nn import jax_param_paths

RTOL = 1e-10
PRESETS = ('default', 'ferminet')
# parameter groups (JAX module paths) of the small presets on LiH
N_GROUPS = {'default': 25, 'ferminet': 6}
MOLS = [('H2', 'init_sample'), ('LiH', 'init_sample'), ('LiH', 'selfgolden'),
        ('H2O', 'init_sample'), ('Li', 'init_sample')]


@functools.cache
def _jax_model(mol, preset, full_determinant=True):
    """``jax_model`` of the small preset, initialised once per module (the
    LiH walkers of both sources and the conversion test share it)."""
    return jax_model(mol, preset=preset, full_determinant=full_determinant)


def check_psi(preset, mol, source, full_determinant):
    """Sign exactly and log|psi| to RTOL against JAX on 4 walkers of ``source``."""
    over = {'full_determinant': full_determinant}
    hamil_j, ansatz, params = _jax_model(mol, preset, full_determinant)
    hamil_t, wf = torch_model(mol, params, preset=preset, overrides=over)
    r = walkers(hamil_j, source, n=4)
    want = jit_once(jax.vmap(ansatz.apply, (None, 0)))(params, jax_phys_conf(hamil_j, r))
    with torch.inference_mode():
        got = wf(torch_phys_conf(hamil_t, r))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.log.numpy(), np.asarray(want.log), rtol=RTOL)


# the ``default`` preset's cases; FermiNet's are in test_torch_zoo_ferminet.py
@pytest.mark.parametrize('preset, mol, source, full_determinant', [
    *(('default', *m, f) for m in MOLS for f in (True, False)),
    # the PsiFormer takes the JAX preset's full_determinant too
    ('psiformer', 'H2O', 'init_sample', False), ('psiformer', 'Li', 'init_sample', False),
])
def test_psi_matches_jax(preset, mol, source, full_determinant):
    check_psi(preset, mol, source, full_determinant)


@pytest.mark.parametrize('preset', PRESETS)
def test_conversion_covers_every_parameter(preset):
    """JAX's parameter paths are the port's, one to one, and a foreign path is refused."""
    _, _, params = _jax_model('LiH', preset)
    params = {path: dict(bundle) for path, bundle in params.items()}
    _, wf = torch_model('LiH', params, preset=preset)
    paths = jax_param_paths(wf)
    assert len(params) == N_GROUPS[preset]
    assert {f'{p}/{n}' for p, n in paths.values()} == {
        f'{p}/{n}' for p, bundle in params.items() for n in bundle
    }
    assert len(paths) == len(list(wf.parameters()))
    loaded = state_dict_from_jax(params, wf)
    for key, (path, name) in paths.items():
        np.testing.assert_array_equal(loaded[key].numpy(), params[path][name])
    params['neural_network_wave_function/omni_net/extra'] = {'w': np.zeros(3)}
    with pytest.raises(KeyError):
        state_dict_from_jax(params, wf)


@pytest.mark.parametrize('preset', PRESETS)
def test_initial_weights_have_the_spread_of_jax_inits(preset):
    """The full-width preset on LiH: each weight and bias of the port's seeded
    draw against JAX's ``init`` of the same path, by standard deviation
    within 5 standard errors of both samples; constant inits (zero biases,
    the ones of ``conf_coeff``, the envelopes) exactly equal."""
    hamil_j = dqj.MolecularHamiltonian(mol=molecule(dqj, 'LiH'))
    ansatz = instantiate_ansatz(hamil_j, jax_ansatz_preset(preset))
    pc = init_sample(hamil_j, 1, 0)[0]
    want = jit_once(ansatz.init)(jax.random.PRNGKey(1), pc)
    hamil_t = dqt.MolecularHamiltonian(mol=molecule(dqt, 'LiH'))
    wf = dqt.ansatz_preset(preset, seed=3)(hamil_t)
    n_random = 0
    for key, (path, name) in jax_param_paths(wf).items():
        got, ref = wf.state_dict()[key].double().numpy(), np.asarray(want[path][name])
        assert got.shape == ref.shape, (path, name)
        if ref.std() == 0:
            np.testing.assert_array_equal(got, ref, err_msg=f'{path}/{name}')
            continue
        n_random += 1
        se = ref.std() * np.sqrt(1 / (2 * got.size) + 1 / (2 * ref.size))
        assert abs(got.std() - ref.std()) <= 5 * se, (path, name, got.std(), ref.std())
        assert abs(got.mean()) <= 5 * ref.std() / np.sqrt(got.size), (path, name)
    assert n_random >= {'default': 30, 'ferminet': 10}[preset]


@pytest.mark.parametrize('preset', PRESETS)
def test_presets_refuse_an_empty_spin(preset):
    """Triplet H2 has no down electron: the JAX package's ``default`` fails
    to build its edges and its FermiNet gives NaN, so the port refuses both."""
    hamil = dqt.MolecularHamiltonian(mol=molecule(dqt, 'H2_triplet'))
    with pytest.raises(ValueError, match='n_down=0'):
        dqt.ansatz_preset(preset)(hamil)


def test_ansatz_preset_names():
    hamil = dqt.MolecularHamiltonian(mol=molecule(dqt, 'H2'))
    wf = dqt.ansatz_preset('deeperwin', n_determinants=2, embedding_dim=8, n_interactions=2,
                           two_particle_stream_dim=4)(hamil)
    assert wf.n_det == 2 and len(wf.omni.gnn.layers) == 2
    assert wf.omni.gnn.out_dims == (32, 8) and wf.omni.gnn.nuclei_embedding is not None
    with pytest.raises(ValueError, match='block_kernel'):  # no PsiFormer block to fuse
        dqt.ansatz_preset('ferminet', embedding_dim=8, n_interactions=1, block_kernel=True)(hamil)
    with pytest.raises(ValueError, match='unknown ansatz preset'):
        dqt.ansatz_preset('paulinet')
    wf = dqt.ansatz_preset('psiformer', n_determinants=2, embedding_dim=8, n_interactions=1,
                           num_heads=2)(hamil)
    assert wf.n_det == 2 and len(wf.omni.gnn.layers) == 1


TREE_SMALL = {
    'default': ['ansatz.omni_factory.gnn_factory.two_particle_stream_dim=8'],
    'ferminet': ['ansatz.omni_factory.gnn_factory.two_particle_stream_dim=8'],
    'deeperwin': ['ansatz.omni_factory.gnn_factory.two_particle_stream_dim=8'],
    'psiformer': ['ansatz.omni_factory.embedding_dim=32'],
}


@pytest.mark.parametrize('preset', sorted(TREE_SMALL))
def test_packaged_tree_builds_its_preset(preset):
    """``ansatz=<preset>`` through the tree reader and ``ansatz_preset`` at the
    same small widths: the same parameters (names, shapes, count) and, on
    the same weights, the same log|psi| bit for bit."""
    from deepqmc_tpu_torch import config

    small = small_kwargs(preset, **({'num_heads': 4} if preset == 'psiformer' else {}))
    overrides = [f'ansatz={preset}', 'hamil/mol=LiH', 'ansatz.n_determinants=2',
                 'ansatz.omni_factory.gnn_factory.n_interactions=2', *TREE_SMALL[preset]]
    if preset != 'psiformer':
        overrides.append('ansatz.omni_factory.embedding_dim=16')
    cfg = config.compose(overrides=overrides)
    hamil = config.instantiate(cfg['hamil'], root=cfg)
    tree = config.instantiate(cfg['ansatz'], root=cfg)(hamil).double()
    preset_wf = dqt.ansatz_preset(preset, **small, seed=1)(hamil).double()
    assert {k: v.shape for k, v in tree.state_dict().items()} == {
        k: v.shape for k, v in preset_wf.state_dict().items()}
    assert jax_param_paths(tree) == jax_param_paths(preset_wf)
    tree.load_state_dict(preset_wf.state_dict())
    r = torch.as_tensor(np.random.default_rng(0).normal(size=(3, hamil.n_up + hamil.n_down, 3)))
    pc = torch_phys_conf(hamil, r.numpy())
    with torch.inference_mode():
        a, b = tree(pc), preset_wf(pc)
    assert torch.equal(a.log, b.log) and torch.equal(a.sign, b.sign)
