"""The port's DeepErwin ansatz against the JAX package.

The small ``deeperwin`` preset (2 determinants, embedding 16, 2 interactions,
two-particle width 8; the nuclei's atom-type table, the 'ne' edges convolved
with the nuclear embeddings without ``w``, one two-particle net per edge
type, the softplus backflow and envelope exponents) with JAX's parameters
converted by ``deepqmc_tpu_torch.convert``, on LiH (per-spin
determinants) and H2O (full determinants): sign exactly and log|psi| to
relative 1e-10; E_loc
and its terms (forward Laplacian) to relative 1e-9; the VMC loss and its
gradient, and one KFAC step, whose ``Embed`` table is a generic parameter
as in JAX's KFAC, to the tolerances of ``test_torch_zoo_train.py``; the
parameter paths one to one, and the full-width preset's initial weights
(fan-average uniform) and zero biases against JAX's ``init``.  Each JAX
program is compiled once per module.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_close,
    grads_by_jax_path,
    init_sample,
    jax_batch,
    jax_model,
    jax_phys_conf,
    jit_once,
    molecule,
    torch_model,
    torch_phys_conf,
    walkers,
)

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt
from deepqmc_tpu.kfac import KFAC as JaxKFAC
from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import median_log_squeeze_and_mask as jax_clip
from deepqmc_tpu.presets import ansatz_preset as jax_ansatz_preset
from deepqmc_tpu.utils import ConstantSchedule as JaxConstant
from deepqmc_tpu.utils import InverseSchedule as JaxInverse
from deepqmc_tpu.wf import instantiate_ansatz
from deepqmc_tpu_torch.convert import state_dict_from_jax
from deepqmc_tpu_torch.kfac import KFAC
from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
from deepqmc_tpu_torch.nn import jax_param_paths
from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule

PSI_RTOL, ELOC_RTOL = 1e-10, 1e-9
REL, REL_STEP = 1e-10, 1e-9
TERMS = ('E_kin', 'V_loc', 'V_el', 'lap', 'quantum_force')
B = 8


@functools.cache
def _jax(mol, full):
    """(hamiltonian, ansatz, params, psi and E_loc of 4 walkers), compiled once."""
    hamil, ansatz, params = jax_model(mol, preset='deeperwin', full_determinant=full)
    r = walkers(hamil, 'init_sample', n=4, seed=2)
    pc = jax_phys_conf(hamil, r)
    psi = jit_once(jax.vmap(ansatz.apply, (None, 0)))(params, pc)
    eloc, stats = jit_once(jax.vmap(hamil.local_energy(ansatz.apply), (None, None, 0)))(
        None, params, pc)
    want = {'E_loc': np.asarray(eloc), **{k: np.asarray(stats[f'hamil/{k}']) for k in TERMS}}
    return hamil, ansatz, params, r, psi, want


# both molecules and both determinant layouts (the loss and KFAC tests add
# H2O's full determinants on other walkers)
CASES = [('LiH', False), ('H2O', True)]


@pytest.mark.parametrize('mol, full', CASES, ids=lambda v: str(v))
def test_psi_matches_jax(mol, full):
    _, _, params, r, want, _ = _jax(mol, full)
    hamil, wf = torch_model(mol, params, preset='deeperwin',
                            overrides={'full_determinant': full})
    with torch.inference_mode():
        got = wf(torch_phys_conf(hamil, r))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.log.numpy(), np.asarray(want.log), rtol=PSI_RTOL)


@pytest.mark.parametrize('mol, full', CASES, ids=lambda v: str(v))
def test_local_energy_matches_jax(mol, full):
    _, _, params, r, _, want = _jax(mol, full)
    hamil, wf = torch_model(mol, params, preset='deeperwin',
                            overrides={'full_determinant': full})
    with torch.inference_mode():
        eloc, stats = hamil.local_energy(wf, torch_phys_conf(hamil, r))
    got = {'E_loc': eloc.numpy(), **{k: stats[f'hamil/{k}'].numpy() for k in TERMS}}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=ELOC_RTOL, err_msg=key)


def test_conversion_covers_every_parameter():
    """JAX's parameter paths are the port's, one to one: the nuclear table,
    the per-type two-particle nets ``u{type}``, the convolution's ``w``/``h``
    (no ``w_ne``) and the envelopes."""
    _, _, params, *_ = _jax('LiH', False)
    _, wf = torch_model('LiH', params, preset='deeperwin', overrides={'full_determinant': False})
    paths = jax_param_paths(wf)
    assert {f'{p}/{n}' for p, n in paths.values()} == {
        f'{p}/{n}' for p, bundle in params.items() for n in bundle}
    assert len(paths) == len(list(wf.parameters()))
    layer = 'neural_network_wave_function/omni_net/electron_gnn/electron_gnnlayer'
    assert f'{layer}/une/linear_0' in params and f'{layer}_1/une/linear_0' not in params
    assert f'{layer}/convolution_electron_update_feature/w_ne/linear_0' not in params
    assert 'embeddings' in params['neural_network_wave_function/omni_net/electron_gnn/'
                                  'nuclei_embedding/embed']


def test_initial_weights_have_the_spread_of_jax_inits():
    """The full-width preset on LiH: each weight of the port's seeded draw
    against JAX's ``init`` of the same path, by standard deviation within 5
    standard errors of both samples (fan-average uniform); the biases, the
    envelopes and the atom-type table's constant-free draw as JAX's."""
    hamil_j = dqj.MolecularHamiltonian(mol=molecule(dqj, 'LiH'))
    ansatz = instantiate_ansatz(hamil_j, jax_ansatz_preset('deeperwin'))
    pc = init_sample(hamil_j, 1, 0)[0]
    want = jit_once(ansatz.init)(jax.random.PRNGKey(1), pc)
    wf = dqt.ansatz_preset('deeperwin', seed=3)(dqt.MolecularHamiltonian(
        mol=molecule(dqt, 'LiH')))
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
        if name == 'w':  # uniform within the fan-average limit
            lim = np.sqrt(3 / ((ref.shape[0] + ref.shape[1]) / 2))
            assert np.abs(got).max() <= lim and np.abs(ref).max() <= lim, (path, name)
    assert n_random >= 30


@pytest.fixture(scope='module')
def trained():
    hamil_j, ansatz, params, *_ = _jax('H2O', True)
    hamil_t, wf = torch_model('H2O', params, preset='deeperwin')
    rs = [walkers(hamil_j, 'init_sample', n=B, seed=20 + k) for k in range(2)]
    return (hamil_j, ansatz, params), (hamil_t, wf), rs


def test_loss_and_gradient_match_jax(trained):
    (hamil_j, ansatz, params), (hamil_t, wf), (r, _) = trained
    loss_j = jax_create_loss_fn(hamil_j, ansatz, jax_clip)
    (want_loss, (want_E, _, _)), (want_grads,) = jax.jit(loss_j.value_and_grad)(
        [params], jax.random.PRNGKey(0), jax_batch(hamil_j, r))
    (loss, (E, _, _)), grads = create_loss_fn(hamil_t, wf, median_log_squeeze_and_mask) \
        .value_and_grad(torch_phys_conf(hamil_t, r), torch.ones(B, dtype=torch.float64))
    assert_close(loss, want_loss, REL, 'loss')
    assert_close(E, np.asarray(want_E)[0, 0], REL, 'E_loc')
    got = grads_by_jax_path(grads, wf)
    want = {(p, n): g for p, bundle in want_grads.items() for n, g in bundle.items()}
    assert set(got) == set(want)
    for key, g in want.items():
        assert_close(got[key], g, REL, '/'.join(key))
    assert all(torch.count_nonzero(g) for g in grads.values())


def test_kfac_step_matches_jax(trained):
    """One KFAC step (inverses refreshed): the same dense layers on both
    sides, the nuclear table not among them, then the parameters (the table
    by the generic rule ``g / (1 + damping)``), E_loc, the stats, the factors
    and the inverses."""
    (hamil_j, ansatz, params), (hamil_t, wf), (_, r) = trained
    wf.load_state_dict(state_dict_from_jax(params, wf))
    kw = dict(norm_constraint=1e-3, inverse_update_period=2)
    kfac_j = JaxKFAC(jax_create_loss_fn(hamil_j, ansatz, jax_clip).value_and_grad,
                     learning_rate_schedule=JaxInverse(0.05, 10000),
                     damping_schedule=JaxConstant(1e-3), **kw)
    kfac_j.bind_ansatz(ansatz)
    kfac_t = KFAC(create_loss_fn(hamil_t, wf, median_log_squeeze_and_mask),
                  learning_rate_schedule=InverseSchedule(0.05, 10000),
                  damping_schedule=ConstantSchedule(1e-3), **kw)
    batch, pc = jax_batch(hamil_j, r), torch_phys_conf(hamil_t, r)
    rng = jax.random.PRNGKey(0)
    state_j = kfac_j.init(rng, [params], batch)
    state_t = kfac_t.init(pc)
    assert [tuple(m) for m in kfac_t.metas] == [tuple(m) for m in kfac_j._layer_meta]
    assert not any('nuclei_embedding' in m.path for m in kfac_t.metas)
    (new,), state_j, (E_j, _, _), stats_j = jax.jit(kfac_j.step)(rng, [params], state_j, batch)
    state_t, (E_t, _, _), stats_t = kfac_t.step(state_t, pc, torch.ones(B, dtype=torch.float64))
    paths = jax_param_paths(wf)
    for key, value in wf.state_dict().items():
        path, name = paths[key]
        assert_close(value, new[path][name], REL_STEP, f'{path}/{name}')
    assert_close(E_t, np.asarray(E_j)[0, 0], REL, 'E_loc')
    assert set(stats_t) == set(stats_j)
    for k, v in stats_j.items():
        assert_close(stats_t[k], v, REL_STEP, k)
    for key in ('factors', 'inverses'):
        for path, pair in state_j[key][0].items():
            for got_m, want_m in zip(state_t[key][path], pair):
                assert_close(got_m, want_m, REL_STEP, f'{key} of {path}')
