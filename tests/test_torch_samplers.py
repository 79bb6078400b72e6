"""The port's electron samplers beyond plain Metropolis against the JAX package
at float64: ``MetropolisSampler`` with ``max_age`` and without tau adaptation,
``clean_force`` and its parts, and ``LangevinSampler``.

The two packages' random streams never match, so each JAX call runs with
``jax.random.normal`` and ``uniform`` replaced by numpy draws, and the port's
sampler with its ``normal`` and ``uniform`` replaced by the same draws
(``torch_parity.feed_draws``).  The JAX side is jitted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_close,
    assert_sampler_states,
    assert_stats,
    feed_draws,
    jax_phys_conf,
    models,
    molecule,
)

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt
from deepqmc_tpu import physics as jax_physics
from deepqmc_tpu.sampling import electron_samplers as jax_samplers
from deepqmc_tpu.sampling import sampling_utils as jax_sampling_utils
from deepqmc_tpu_torch import physics
from deepqmc_tpu_torch.sampling import LangevinSampler, MetropolisSampler, sampling_utils
from deepqmc_tpu_torch.types import PhysicalConfiguration

REL = 1e-12


@functools.cache
def jax_update(mol, seed, cls_j, tau):
    """The JAX sampler's state of the walkers of :func:`models` (its ``update``
    does not depend on ``max_age`` or ``target_acceptance``)."""
    hamil_j, ansatz, params, _, _, r = models(mol, seed)
    return jax.jit(cls_j(hamil_j, ansatz.apply, tau=tau).update)(
        {'r': jnp.asarray(r), 'age': jnp.zeros(len(r), jnp.int32), 'tau': jnp.asarray(tau)},
        params, jnp.asarray(hamil_j.mol.coords))


def states(mol, cls_j, cls_t, seed=0, tau=0.3, ages=None, **kwargs):
    """(JAX sampler, params, R, state; port sampler, R, state; wf) on the same
    walkers and ages, each state's psi (and force) by its own ``update``."""
    hamil_j, ansatz, params, hamil_t, wf, r = models(mol, seed)
    age = np.zeros(len(r), dtype=int) if ages is None else ages
    sampler_j = cls_j(hamil_j, ansatz.apply, tau=tau, **kwargs)
    R_j = jnp.asarray(hamil_j.mol.coords)
    state_j = {**jax_update(mol, seed, cls_j, tau), 'age': jnp.asarray(age, jnp.int32)}
    sampler_t = cls_t(hamil_t, wf, tau=tau, **kwargs)
    R_t = torch.as_tensor(hamil_t.mol.coords)
    with torch.no_grad():
        state_t = sampler_t.update(
            {'r': torch.tensor(r), 'age': torch.tensor(age),
             'tau': torch.tensor(tau, dtype=torch.float64)}, R_t)
    return (sampler_j, params, R_j, state_j), (sampler_t, R_t, state_t), wf


@pytest.mark.parametrize('kwargs', [
    dict(max_age=2),
    dict(target_acceptance=None),
    dict(max_age=2, target_acceptance=None),
    dict(max_age=0, target_acceptance=0.525),  # 0 turns the forced move off, as in JAX
], ids=['max_age', 'no_target', 'both', 'max_age_0'])
def test_metropolis_move_with_max_age_and_target_matches_jax(kwargs, monkeypatch):
    """One move of the port's sampler against JAX ``MetropolisSampler.sample``:
    the same walkers accepted (ages and the forced walkers equal), r, psi, tau
    and the stats to 1e-12."""
    ages = np.random.default_rng(3).integers(0, 4, size=16)
    (s_j, params, R_j, st_j), (s_t, R_t, st_t), wf = states(
        'LiH', jax_samplers.MetropolisSampler, MetropolisSampler, 0, ages=ages, **kwargs)
    rng = np.random.default_rng(1)
    noise, u = rng.normal(size=tuple(st_t['r'].shape)), rng.uniform(size=16)
    feed_draws(monkeypatch, [noise], [u])
    want, _, want_stats = jax.jit(s_j.sample)(jax.random.PRNGKey(0), st_j, params, R_j)
    with torch.no_grad():
        got, pc, got_stats = s_t.sample(None, st_t, R_t)
        by_ratio = (2 * (wf(s_t.phys_conf(R_t, st_t['r'] + 0.3 * torch.tensor(noise))).log
                         - st_t['psi'].log) > torch.log(torch.tensor(u))).numpy()
    accepted = np.asarray(want['age']) == 0
    assert 0 < by_ratio.sum() and by_ratio.sum() < len(by_ratio)
    if kwargs.get('max_age'):
        forced = accepted & ~by_ratio
        assert forced.any() and (ages[forced] >= kwargs['max_age']).all()
    else:
        np.testing.assert_array_equal(accepted, by_ratio)
    assert_sampler_states(got, want, ('r', 'psi', 'tau'))
    assert_stats(got_stats, want_stats)
    if kwargs.get('target_acceptance', 0.57) is None:
        assert got['tau'].item() == 0.3
    assert torch.equal(pc.r, got['r'])


def test_pairwise_diffs_and_nearest_nucleus_match_jax():
    rng = np.random.default_rng(0)
    r, R = rng.normal(size=(5, 4, 3)), rng.normal(size=(3, 3))
    assert_close(physics.pairwise_diffs(torch.tensor(r), torch.tensor(R)),
                 jax_physics.pairwise_diffs(jnp.asarray(r), jnp.asarray(R)), 1e-15)
    got, got_idx = sampling_utils.diffs_to_nearest_nuc(torch.tensor(r), torch.tensor(R))
    want, want_idx = jax.vmap(jax_sampling_utils.diffs_to_nearest_nuc, (0, None))(
        jnp.asarray(r), jnp.asarray(R))
    assert_close(got, want, 1e-15)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize('mol, tau', [('LiH', 0.3), ('H2O', 1.0), ('H2O', 0.01)])
def test_clean_force_matches_jax(mol, tau):
    """The regularised force on walkers with electrons within 0.05 bohr of a
    nucleus and large raw forces, so the crossover damps and the cap acts."""
    hamil_j = dqj.MolecularHamiltonian(mol=molecule(dqj, mol))
    hamil_t = dqt.MolecularHamiltonian(mol=molecule(dqt, mol))
    R = np.asarray(hamil_j.mol.coords)
    rng = np.random.default_rng(5)
    n_elec = hamil_j.n_up + hamil_j.n_down
    r = R[rng.integers(0, len(R), size=(12, n_elec))] + rng.normal(size=(12, n_elec, 3))
    for b, (i, I) in enumerate([(0, 0), (1, 1), (2, 0), (0, len(R) - 1)]):
        step = rng.normal(size=3)
        r[b, i] = R[I] + (0.01 + 0.01 * b) * step / np.linalg.norm(step)
    force = 30 * rng.normal(size=r.shape)
    want = jax_sampling_utils.clean_force(jnp.asarray(force), jax_phys_conf(hamil_j, r),
                                          hamil_j.mol, tau=jnp.asarray(tau))
    pc = PhysicalConfiguration(torch.as_tensor(hamil_t.mol.coords), torch.tensor(r),
                               torch.zeros(len(r), dtype=torch.long))
    got = sampling_utils.clean_force(torch.tensor(force), pc, hamil_t.mol,
                                      tau=torch.tensor(tau, dtype=torch.float64))
    assert_close(got, want, REL)
    # the cap acted on the electrons placed at the nuclei: drift shorter than the raw one
    dist = np.linalg.norm(r[:, :, None] - R, axis=-1).min(-1)
    capped = tau * np.linalg.norm(np.asarray(want), axis=-1) <= dist * (1 + 1e-12)
    assert capped[dist < 0.05].all() and (dist < 0.05).sum() >= 4


def test_langevin_move_matches_jax(monkeypatch, mol='LiH', seed=0, tau=0.1):
    """One Langevin move: the force of the walkers (autograd against
    ``jax.grad``, cleaned with the walker's tau) to 1e-10, then the proposal,
    the Green's-function acceptance, the state (the candidate's force cleaned
    with the old tau) and the stats as for Metropolis; the parameters get no
    ``.grad``."""
    (s_j, params, R_j, st_j), (s_t, R_t, st_t), wf = states(
        mol, jax_samplers.LangevinSampler, LangevinSampler, seed, tau=tau)
    assert_close(st_t['force'], st_j['force'], 1e-10, 'force')
    rng = np.random.default_rng(seed)
    noise, u = rng.normal(size=tuple(st_t['r'].shape)), rng.uniform(size=16)
    feed_draws(monkeypatch, [noise], [u])
    want, _, want_stats = jax.jit(s_j.sample)(jax.random.PRNGKey(0), st_j, params, R_j)
    with torch.no_grad():
        got, _, got_stats = s_t.sample(None, st_t, R_t)
    accepted = np.asarray(want['age']) == 0
    assert 0 < accepted.sum() < len(accepted)  # both branches exercised
    assert_close(got['force'], want['force'], 1e-10, 'force after the move')
    assert_sampler_states(got, want, ('r', 'psi', 'tau'))
    assert_stats(got_stats, want_stats)
    assert all(p.grad is None for p in wf.parameters())


def test_langevin_runs_where_autograd_is_off():
    """The force is taken under ``torch.no_grad()`` (gradients turned back on
    locally) and leaves no graph behind; under inference mode autograd is
    unavailable and the sampler says so by ``uses_autograd``."""
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    wf = dqt.psiformer_ansatz(hamil, n_determinants=1, embedding_dim=8, n_interactions=1,
                              num_heads=2).double()
    s_t, R_t = LangevinSampler(hamil, wf), torch.as_tensor(hamil.mol.coords)
    assert LangevinSampler.uses_autograd and not MetropolisSampler.uses_autograd
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        new, _, _ = s_t.sample(gen, s_t.init(gen, 4, R_t), R_t)
    assert not any(t.requires_grad for t in (new['r'], new['force'], new['psi'].log))
    assert all(p.grad is None for p in wf.parameters())
    with torch.inference_mode(), pytest.raises(RuntimeError, match='no_grad'):
        s_t.sample(gen, new, R_t)


