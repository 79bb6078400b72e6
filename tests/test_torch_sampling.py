"""The port's Metropolis sampler, decorrelation wrapper, walker initialisation
and EWM.

The two packages' random streams never match, so the sampler is checked by
feeding ``MetropolisSampler.step`` the same numpy proposals and uniforms as a
hand-written Metropolis step, and comparing exactly; and as JAX
``MetropolisSampler.sample``, whose ``jax.random.normal`` and ``uniform`` are
replaced within the test by the same numpy draws.  The EWM is a
deterministic recursion and is held to JAX ``ewm.init_ewm`` directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_model, torch_model, walkers

import deepqmc_tpu_torch as dqt
from deepqmc_tpu.ewm import init_ewm as jax_init_ewm
from deepqmc_tpu_torch.ewm import init_ewm
from deepqmc_tpu_torch.sampling import DecorrSampler, MetropolisSampler

SMALL = {'n_determinants': 2, 'embedding_dim': 16, 'n_interactions': 1, 'num_heads': 2}


def _setup(mol='LiH', n=16, seed=0):
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name(mol))
    wf = dqt.psiformer_ansatz(hamil, seed=seed, **SMALL).to(torch.float64)
    R = torch.as_tensor(hamil.mol.coords)
    sampler = MetropolisSampler(hamil, wf, tau=0.3)
    state = sampler.init(torch.Generator().manual_seed(seed), n, R)
    return hamil, wf, R, sampler, state


@torch.inference_mode()
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_metropolis_step_matches_hand_written(seed):
    hamil, wf, R, sampler, state = _setup(seed=seed)
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=tuple(state['r'].shape))
    uniforms = rng.uniform(size=state['r'].shape[0])
    new, phys_conf, stats = sampler.step(state, R, torch.tensor(noise), torch.tensor(uniforms))

    # hand-written reference step
    r_old = state['r'].numpy()
    r_prop = r_old + 0.3 * noise
    logp_old = state['psi'].log.numpy()
    logp_prop = wf(MetropolisSampler.phys_conf(R, torch.tensor(r_prop))).log.numpy()
    accept = 2 * (logp_prop - logp_old) > np.log(uniforms)
    assert 0 < accept.sum() < len(accept)  # both branches exercised
    np.testing.assert_array_equal(new['r'].numpy(), np.where(accept[:, None, None], r_prop, r_old))
    np.testing.assert_array_equal(new['psi'].log.numpy(), np.where(accept, logp_prop, logp_old))
    np.testing.assert_array_equal(new['age'].numpy(), np.where(accept, 0, state['age'].numpy() + 1))
    acc = accept.mean()
    assert stats['sampling/acceptance'].item() == pytest.approx(acc, abs=1e-15)
    assert new['tau'].item() == pytest.approx(0.3 * max(acc, 0.05) / 0.57, rel=1e-14)
    assert torch.equal(phys_conf.r, new['r'])


@torch.inference_mode()
@pytest.mark.parametrize('mol, seed', [('LiH', 0), ('LiH', 1), ('Li', 2)])
def test_metropolis_step_matches_jax(mol, seed, monkeypatch):
    """One move of the port's sampler against JAX ``MetropolisSampler.sample``
    on the same walkers, ages, parameters and noise, at float64: the same
    walkers accepted, so r, age, the step size and the acceptance agree to
    rounding, and psi to the wave function's own parity (1e-12 relative)."""
    from deepqmc_tpu.sampling.electron_samplers import MetropolisSampler as JaxMetropolis

    hamil_j, ansatz, params = jax_model(mol, seed=seed)
    hamil_t, wf = torch_model(mol, params)
    r = walkers(hamil_j, 'init_sample', n=16, seed=seed)
    rng = np.random.default_rng(seed)
    age = rng.integers(0, 5, size=len(r))
    noise, uniforms = rng.normal(size=r.shape), rng.uniform(size=len(r))

    sampler_j = JaxMetropolis(hamil_j, ansatz.apply, tau=0.3)
    R_j = jnp.asarray(hamil_j.mol.coords)
    state_j = sampler_j.update(
        {'r': jnp.asarray(r), 'age': jnp.asarray(age, jnp.int32), 'tau': jnp.asarray(0.3)},
        params, R_j)
    monkeypatch.setattr(jax.random, 'normal', lambda key, shape, dtype: jnp.asarray(noise, dtype))
    monkeypatch.setattr(jax.random, 'uniform', lambda key, shape: jnp.asarray(uniforms))
    want, _, want_stats = sampler_j.sample(jax.random.PRNGKey(0), state_j, params, R_j)

    sampler_t = MetropolisSampler(hamil_t, wf, tau=0.3)
    R_t = torch.as_tensor(hamil_t.mol.coords)
    state_t = sampler_t.update(
        {'r': torch.tensor(r), 'age': torch.tensor(age), 'tau': torch.tensor(0.3, dtype=R_t.dtype)},
        R_t)
    got, _, got_stats = sampler_t.step(state_t, R_t, torch.tensor(noise), torch.tensor(uniforms))

    accepted = np.asarray(want['age']) == 0
    assert 0 < accepted.sum() < len(accepted)  # both branches exercised
    np.testing.assert_array_equal(got['age'].numpy(), np.asarray(want['age']))
    np.testing.assert_array_equal(got['psi'].sign.numpy(), np.asarray(want['psi'].sign))
    for key, g, w in (('r', got['r'], want['r']), ('psi', got['psi'].log, want['psi'].log),
                      ('tau', got['tau'], want['tau'])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0, err_msg=key)
    assert set(got_stats) == set(want_stats)
    for key, value in want_stats.items():
        np.testing.assert_allclose(got_stats[key].numpy(), np.asarray(value), rtol=1e-12,
                                   atol=1e-14, err_msg=key)


@torch.inference_mode()
def test_decorr_sampler_repeats_the_inner_move():
    _, _, R, inner, state = _setup(seed=3)
    decorr = DecorrSampler(length=3).wrap(inner)
    got, _, stats = decorr.sample(torch.Generator().manual_seed(5), state, R)
    gen = torch.Generator().manual_seed(5)
    want = state
    for _ in range(3):
        want, _, want_stats = inner.sample(gen, want, R)
    for key in ('r', 'age', 'tau'):
        assert torch.equal(got[key], want[key])
    assert torch.equal(got['psi'].log, want['psi'].log)
    assert stats['sampling/acceptance'] == want_stats['sampling/acceptance']


@torch.inference_mode()
def test_psi_cache_update_matches_fresh_evaluation():
    _, wf, R, sampler, state = _setup(seed=4)
    state = {**state, 'r': state['r'] + 0.1}
    fresh = wf(MetropolisSampler.phys_conf(R, state['r']))
    updated = sampler.update(state, R)
    assert torch.equal(updated['psi'].log, fresh.log)
    assert torch.equal(updated['psi'].sign, fresh.sign)


@pytest.mark.parametrize('mol, outcomes', [
    # the bond walk starts at a random atom among those with the most open
    # seats, so each molecule has two outcomes, (up, down) per atom in order
    ('H2O', [[(4, 4), (1, 0), (0, 1)], [(4, 4), (0, 1), (1, 0)]]),
    ('LiH', [[(2, 1), (0, 1)], [(1, 2), (1, 0)]]),
    ('H2', [[(1, 0), (0, 1)], [(0, 1), (1, 0)]]),
])
def test_init_sample_seats_and_spins(mol, outcomes):
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name(mol))
    gen = torch.Generator().manual_seed(0)
    n = 64
    seats = hamil._seat_electrons(gen, n, torch.device('cpu'))
    up, down = hamil._distribute_spins(gen, torch.as_tensor(hamil.mol.coords), seats)
    per_walker = [list(map(tuple, w)) for w in torch.stack([up, down], -1).tolist()]
    assert all(w in outcomes for w in per_walker)
    assert all(o in per_walker for o in outcomes)
    pc = hamil.init_sample(gen, n)
    assert pc.r.shape == (n, hamil.n_up + hamil.n_down, 3)
    assert torch.isfinite(pc.r).all()


def test_init_sample_clouds_sit_on_the_nuclei():
    """Mean electron position per spin channel of H2O lies near the nuclei
    (the clouds are centred on them, width sqrt(Z))."""
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2O'))
    pc = hamil.init_sample(torch.Generator().manual_seed(1), 4096)
    R = torch.as_tensor(hamil.mol.coords)
    # electron 0 of each spin sits on the oxygen for every walker
    for i in (0, hamil.n_up):
        mean = pc.r[:, i].mean(0)
        assert torch.linalg.vector_norm(mean - R[0]) < 0.2


@pytest.mark.parametrize('n_values', [1, 5, 40])
def test_ewm_matches_jax(n_values):
    xs = np.random.default_rng(n_values).normal(size=n_values) - 75.0
    state_j, update_j = jax_init_ewm(window_size=16)
    state_t, update_t = init_ewm(window_size=16)
    for x in xs:
        state_j = update_j(jnp.asarray(x), state_j)
        state_t = update_t(x, state_t)
    for key in ('mean', 'var', 'sqerr'):
        np.testing.assert_allclose(
            getattr(state_t, key).item(), float(getattr(state_j, key)), rtol=1e-12, atol=1e-14
        )
