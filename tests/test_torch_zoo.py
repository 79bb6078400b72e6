"""The port's FermiNet and PauliNet-style ``default`` ansätze against the JAX
package.

The small presets (2 determinants, embedding 16, 2 interactions, two-particle
width 8) with full and per-spin determinants on H2, LiH, H2O and the
open-shell Li atom (2 up, 1 down), with JAX's parameters converted by
``deepqmc_tpu_torch.convert``; walkers from JAX ``init_sample`` and, for LiH,
the pinned self-golden walker; the small PsiFormer with per-spin
determinants too.  Sign exactly, log|psi| to relative 1e-10 at float64.
Also: the conversion covers every parameter both ways, the
initial weights have the spread of JAX's initialisers, and the presets
refuse what they cannot build.
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import (
    jax_model,
    jax_phys_conf,
    molecule,
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


@pytest.mark.parametrize('preset, mol, source, full_determinant', [
    *((p, *m, f) for p in PRESETS for m in MOLS for f in (True, False)),
    # the PsiFormer takes the JAX preset's full_determinant too
    ('psiformer', 'H2O', 'init_sample', False), ('psiformer', 'Li', 'init_sample', False),
])
def test_psi_matches_jax(preset, mol, source, full_determinant):
    over = {'full_determinant': full_determinant}
    hamil_j, ansatz, params = jax_model(mol, preset=preset, **over)
    hamil_t, wf = torch_model(mol, params, preset=preset, overrides=over)
    r = walkers(hamil_j, source, n=4)
    want = jax.jit(jax.vmap(ansatz.apply, (None, 0)))(params, jax_phys_conf(hamil_j, r))
    with torch.inference_mode():
        got = wf(torch_phys_conf(hamil_t, r))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.log.numpy(), np.asarray(want.log), rtol=RTOL)


@pytest.mark.parametrize('preset', PRESETS)
def test_conversion_covers_every_parameter(preset):
    """JAX's parameter paths are the port's, one to one, and a foreign path is refused."""
    _, _, params = jax_model('LiH', preset=preset)
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
    pc = hamil_j.init_sample(jax.random.PRNGKey(0), hamil_j.mol.coords, 1)[0]
    want = ansatz.init(jax.random.PRNGKey(1), pc)
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
    with pytest.raises(NotImplementedError, match='queue 1 item 8'):
        dqt.ansatz_preset('deeperwin')
    with pytest.raises(ValueError, match='unknown ansatz preset'):
        dqt.ansatz_preset('paulinet')
    wf = dqt.ansatz_preset('psiformer', n_determinants=2, embedding_dim=8, n_interactions=1,
                           num_heads=2)(hamil)
    assert wf.n_det == 2 and len(wf.omni.gnn.layers) == 1
