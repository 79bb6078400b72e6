"""The port's combined samplers and EWM grid against the JAX package at
float64: ``MoleculeIdxSampler`` (with the permutation fed to both, since the
random streams never match), ``MultiNuclearGeometrySampler`` over two LiH
geometries (the psi refresh of every molecule, one sample call on molecule 1:
the layout, the ``mol_idx`` stamp, the untouched molecule), the nuclear
period with ``IdleNucleiSampler``, the state axis of size 1, and
``init_multi_mol_multi_state_ewm`` with subset updates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, assert_stats, feed_draws, models

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt
from deepqmc_tpu.ewm import init_multi_mol_multi_state_ewm as jax_ewm_grid
from deepqmc_tpu.sampling import combined_samplers as jax_combined
from deepqmc_tpu.sampling import electron_samplers as jax_samplers
from deepqmc_tpu.sampling import sampling_utils as jax_sampling_utils
from deepqmc_tpu.utils import tree_stack as jax_tree_stack
from deepqmc_tpu_torch.ewm import init_multi_mol_multi_state_ewm
from deepqmc_tpu_torch.sampling import (
    DecorrSampler,
    IdleNucleiSampler,
    MetropolisSampler,
    MoleculeIdxSampler,
    MultiElectronicStateSampler,
    MultiNuclearGeometrySampler,
    chain,
    initialize_sampling,
    no_elec_warp,
)
from deepqmc_tpu_torch.types import PhysicalConfiguration

REL = 1e-12


@pytest.mark.parametrize('shuffle', [False, 'once', 'always'])
@pytest.mark.parametrize('n_mols, batch_size', [(3, 1), (3, 2), (4, 3)])
def test_molecule_idx_sampler_matches_jax(shuffle, n_mols, batch_size, monkeypatch):
    perms = [np.random.default_rng(k).permutation(n_mols) for k in range(8)]
    drawn = {'jax': 0, 'torch': 0}

    def nxt(side):
        drawn[side] += 1
        # the JAX package redraws 'once' from the same key: the same permutation
        return perms[0 if shuffle == 'once' else drawn[side] - 1]

    monkeypatch.setattr(jax.random, 'permutation', lambda key, n: jnp.asarray(nxt('jax')))
    want = jax_combined.MoleculeIdxSampler(jax.random.PRNGKey(0), n_mols, batch_size, shuffle)
    got = MoleculeIdxSampler(torch.Generator().manual_seed(0), n_mols, batch_size, shuffle)
    monkeypatch.setattr(got, '_permutation', lambda: torch.as_tensor(nxt('torch')))
    for _ in range(7):
        idxs = got.sample()
        assert idxs.dtype == torch.long and idxs.device.type == 'cpu'
        np.testing.assert_array_equal(idxs.numpy(), np.asarray(want.sample()))
    if shuffle == 'once':
        assert drawn['torch'] == 1


def test_molecule_idx_sampler_shuffle_settings():
    with pytest.raises(ValueError, match='shuffle'):
        MoleculeIdxSampler(torch.Generator(), 3, 1, shuffle=True)
    gen = torch.Generator().manual_seed(0)
    seen = torch.cat([MoleculeIdxSampler(gen, 5, 5, 'always').sample() for _ in range(3)])
    assert sorted(seen.tolist()) == sorted(list(range(5)) * 3)


def _two_geometries(package, hamil):
    coords = np.asarray(hamil.mol.coords)
    stretched = coords.copy()
    stretched[1:] = coords[0] + 1.1 * (coords[1:] - coords[0])
    mol = hamil.mol
    return [mol, package.Molecule(coords=stretched, charges=mol.charges, charge=mol.charge,
                                  spin=mol.spin)]


def test_multi_nuclear_geometry_sampler_matches_jax(monkeypatch):
    """Two LiH geometries, one electronic state, 16 walkers each: the psi
    refresh of both molecules, then one sample call (2 Metropolis moves) on
    molecule 1 with the same draws; the layout, the stamp and molecule 0
    left bit for bit."""
    hamil_j, ansatz, params, hamil_t, wf, r = models('LiH')
    mols_j, mols_t = _two_geometries(dqj, hamil_j), _two_geometries(dqt, hamil_t)
    _, smp_j = jax_sampling_utils.initialize_sampling(
        jax.random.PRNGKey(0), hamil_j, ansatz, mols_j, 1, 1,
        elec_sampler=lambda hamil, wf: jax_sampling_utils.chain(
            jax_samplers.DecorrSampler(length=2),
            jax_samplers.MetropolisSampler(hamil, wf, tau=0.3)))
    _, smp_t = initialize_sampling(
        torch.Generator().manual_seed(0), hamil_t, wf, mols_t, 1, 1,
        elec_sampler=lambda hamil, wf: chain(DecorrSampler(length=2),
                                             MetropolisSampler(hamil, wf, tau=0.3)))
    rs = np.stack([r, 1.1 * r])[:, None]  # [mol, state, walker, electron, 3]
    R = np.stack([m.coords for m in mols_j])
    params_j = jax_tree_stack([params])  # the state axis of the parameters
    st_j = jax.jit(smp_j.update)({
        'nuc': {'R': jnp.asarray(R)},
        'elec': {'r': jnp.asarray(rs), 'age': jnp.zeros(rs.shape[:3], jnp.int32),
                 'tau': jnp.full((2, 1), 0.3)},
        'update_nuc_counter': jnp.zeros(2),
    }, params_j)
    with torch.no_grad():
        st_t = smp_t.update({
            'nuc': {'R': torch.tensor(R)},
            'elec': {'r': torch.tensor(rs), 'age': torch.zeros(rs.shape[:3], dtype=torch.long),
                     'tau': torch.full((2, 1), 0.3, dtype=torch.float64)},
            'update_nuc_counter': torch.zeros(2, dtype=torch.long),
        })
    assert_close(st_t['elec']['psi'].log, st_j['elec']['psi'].log, REL, 'psi of both molecules')

    rng = np.random.default_rng(0)
    noise, u = rng.normal(size=r.shape), rng.uniform(size=len(r))
    feed_draws(monkeypatch, [noise], [u])
    want, pc_j, stats_j = jax.jit(smp_j.sample)(jax.random.PRNGKey(1), st_j, params_j,
                                                jnp.array([1]))
    with torch.no_grad():
        got, pc_t, stats_t = smp_t.sample(None, st_t, torch.tensor([1]))

    assert set(got) == set(want) and set(got['elec']) == set(want['elec'])
    for key in ('r', 'age', 'tau'):
        assert tuple(got['elec'][key].shape) == want['elec'][key].shape
        assert_close(got['elec'][key], want['elec'][key], REL, key)
        assert torch.equal(got['elec'][key][0], st_t['elec'][key][0])  # molecule 0 untouched
    assert torch.equal(got['elec']['psi'].log[0], st_t['elec']['psi'].log[0])
    assert_close(got['elec']['psi'].log, want['elec']['psi'].log, REL, 'psi')
    moved = np.asarray(want['elec']['age'])[1, 0] == 0
    assert 0 < moved.sum() < len(moved)
    assert not torch.equal(got['elec']['r'][1], st_t['elec']['r'][1])
    np.testing.assert_array_equal(got['update_nuc_counter'].numpy(),
                                  np.asarray(want['update_nuc_counter']))
    # the configuration: r and the stamp as JAX's, one geometry per molecule of the batch
    assert tuple(pc_t.r.shape) == pc_j.r.shape == (1, 1, 16, 4, 3)
    assert_close(pc_t.r, pc_j.r, REL, 'phys_conf.r')
    np.testing.assert_array_equal(pc_t.mol_idx.numpy(), np.asarray(pc_j.mol_idx))
    assert (pc_t.mol_idx == 1).all()
    assert_close(pc_t.R, np.asarray(pc_j.R)[:, 0, 0], REL, 'phys_conf.R')
    assert all(v.shape == (1, 1) for v in stats_t.values())
    assert_stats(stats_t, stats_j)


class _SpySampler:
    """An electron sampler that records its calls and moves every walker by 1."""

    def __init__(self):
        self.calls = []

    def init(self, gen, n, R):
        return {'r': torch.zeros(n, 2, 3) + R.sum(), 'tau': torch.tensor(1.0)}

    def update(self, state, R):
        self.calls.append('update')
        return state

    def sample(self, gen, state, R):
        self.calls.append('sample')
        r = state['r'] + 1
        return {**state, 'r': r}, PhysicalConfiguration(R, r, torch.zeros(len(r))), {}


@pytest.mark.parametrize('eq_steps', [None, 3])
def test_nuclear_period_refreshes_and_reequilibrates(eq_steps):
    """With ``update_nuc_period`` 2 the idle nuclei 'move' on every second
    visit of a molecule (its counter at period - 1, as in the JAX package):
    psi is refreshed and ``elec_equilibration_steps`` moves made before the
    call's own move; the counter restarts and the other molecule's stays."""
    spy = _SpySampler()
    sampler = MultiNuclearGeometrySampler(
        MultiElectronicStateSampler(spy, 1), IdleNucleiSampler([1, 1]), no_elec_warp, 2,
        eq_steps)
    state = sampler.init(None, 4, torch.zeros(2, 2, 3))
    visits = [0, 0, 1, 0, 1]
    counters, calls = [], []
    for i in visits:
        spy.calls.clear()
        state, _, _ = sampler.sample(None, state, torch.tensor([i]))
        counters.append(state['update_nuc_counter'].tolist())
        calls.append(list(spy.calls))
    advance = ['update', *['sample'] * (eq_steps or 0)]
    assert calls == [['sample'], advance + ['sample'], ['sample'], ['sample'],
                     advance + ['sample']]
    assert counters == [[1, 0], [0, 0], [0, 1], [1, 1], [1, 0]]
    assert state['elec']['r'][0, 0, 0, 0, 0].item() == 3 + (eq_steps or 0)


def test_more_than_one_electronic_state_is_not_ported():
    """Several states are ported (``tests/test_torch_excited_train.py``), each
    with its own electron sampler: one sampler for two states is refused."""
    with pytest.raises(ValueError, match='1 electron samplers for 2 states'):
        MultiElectronicStateSampler(_SpySampler(), 2)


def test_ewm_grid_with_subset_updates_matches_jax():
    """An EWM grid [3 molecules, 1 state] updated one molecule at a time: the
    rows named change as JAX's, the others keep their values."""
    state_j, update_j = jax_ewm_grid((3, 1), window_size=8)
    state_t, update_t = init_multi_mol_multi_state_ewm((3, 1), window_size=8)
    rng = np.random.default_rng(0)
    for idxs in ([2], [0], [2], [1], [0, 2], [2], [0], [1], [2]):
        x = rng.normal(size=(len(idxs), 1)) - 8
        before = state_t
        state_j = update_j(jnp.asarray(x), state_j, jnp.asarray(idxs))
        state_t = update_t(torch.tensor(x), state_t, torch.tensor(idxs))
        for name, got, want in zip(state_t._fields, state_t, state_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL, atol=1e-14,
                                       err_msg=name)
        others = [i for i in range(3) if i not in idxs]
        for got, old in zip(state_t, before):
            assert torch.equal(got[others].nan_to_num(), old[others].nan_to_num())
    state_t = update_t(torch.zeros(3, 1), state_t)  # no subset: every row
    assert (state_t.step == torch.tensor([[4], [3], [6]])).all()
