"""The port's equilibration and its training entry points with the new
sampling: ``equilibrate`` against the JAX package's on the same criterion
series (the stub sampler of ``tests/test_sampling.py``), one training step on
weighted walkers with ``median_clip_and_mask`` against the JAX loss and
gradient at float64, and ``train`` and ``evaluate`` on the CPU with the
recipes, equilibration and two geometries."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, feed_draws, grads_by_jax_path, jax_phys_conf, models

import deepqmc_tpu_torch as dqt
from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import median_clip_and_mask as jax_median_clip_and_mask
from deepqmc_tpu.parallel import pexp_normalize_mean as jax_pexp_normalize_mean
from deepqmc_tpu.sampling.sampling_utils import equilibrate as jax_equilibrate
from deepqmc_tpu_torch.ewm import init_multi_mol_multi_state_ewm
from deepqmc_tpu_torch.fit import TrainState, train_step
from deepqmc_tpu_torch.loss import create_loss_fn, median_clip_and_mask
from deepqmc_tpu_torch.sampling import (
    RECIPES,
    DecorrSampler,
    MetropolisSampler,
    ResampledSampler,
    chain,
    equilibrate,
    initialize_sampling,
)

TINY = dict(n_determinants=2, embedding_dim=16, n_interactions=1, num_heads=2)


def _series(pkg, drift, spread):
    """(index sampler, sampler, criterion) of one package: the criterion
    series is stationary noise (or a ramp with ``drift='criterion'``); the
    log|psi| spread is stationary, a ramp (``drift='spread'``) or absent."""
    xp = jnp if pkg == 'jax' else torch

    class IdxSampler:
        def sample(self):
            return xp.asarray([0])

    class Sampler:
        def sample(self, *args):
            state, mol_idxs = args[1], args[-1]  # JAX passes params before mol_idxs
            i = state['i']
            noise = 1e-3 * xp.sin(12.9898 * xp.asarray(i, dtype=xp.float64))
            stats = {} if not spread else {
                'sampling/log_psi/std': 0.1 * i if drift == 'spread' else 1.0 + noise}
            return {'i': i + 1}, i + noise, stats

    def criterion(x):
        x = xp.asarray(x, dtype=xp.float64)
        return 0.05 * x if drift == 'criterion' else 1e-3 * xp.sin(78.233 * x)

    return IdxSampler(), Sampler(), criterion


@pytest.mark.parametrize('drift, spread, early, want', [
    (None, True, True, 'stops'),
    ('spread', True, True, 'runs out'),  # a drifting spread vetoes the stop
    (None, False, True, 'stops'),  # no spread stat: the criterion alone decides
    ('criterion', True, True, 'runs out'),
    (None, True, False, 'runs out'),  # early stopping off
])
def test_equilibrate_stops_where_jax_stops(drift, spread, early, want):
    """The same criterion and spread series through both packages'
    ``equilibrate`` (blocks of 2, windows of 10): the same calls yielded."""
    kwargs = dict(block_size=2, n_blocks=5, allow_early_stopping=early)
    idx_j, smp_j, crit_j = _series('jax', drift, spread)
    steps_j = [step for step, *_ in jax_equilibrate(
        jax.random.PRNGKey(0), {}, idx_j, smp_j, {'i': jnp.array(0)}, crit_j, range(60),
        **kwargs)]
    idx_t, smp_t, crit_t = _series('torch', drift, spread)
    got = list(equilibrate(None, idx_t, smp_t, {'i': torch.tensor(0)}, crit_t, range(60),
                           **kwargs))
    assert [step for step, *_ in got] == steps_j
    assert (len(steps_j) == 60) is (want == 'runs out')
    assert len(steps_j) >= 10  # never before a full window
    step, state, mol_idxs, stats = got[-1]
    assert state['i'].item() == step + 1 and mol_idxs.tolist() == [0]


@functools.cache
def _weighted_step():
    """One port ``train_step`` on 16 LiH walkers carrying fed log-weights,
    through ``ResampledSampler`` and Metropolis, with an optimizer that takes
    the loss's value and gradient on what the step hands it."""
    hamil_j, ansatz, params, hamil_t, wf, r = models('LiH')
    log_weight = np.random.default_rng(4).normal(size=len(r))
    _, sampler = initialize_sampling(
        torch.Generator().manual_seed(0), hamil_t, wf, [hamil_t.mol], 1, 1,
        elec_sampler=lambda hamil, wf: ResampledSampler(period=100).wrap(
            MetropolisSampler(hamil, wf, tau=0.3)))
    R = torch.as_tensor(hamil_t.mol.coords)
    with torch.no_grad():
        elec = MetropolisSampler(hamil_t, wf).update(
            {'r': torch.tensor(r), 'age': torch.zeros(len(r), dtype=torch.long),
             'tau': torch.tensor(0.3, dtype=torch.float64)}, R)
    elec = {**elec, 'step': torch.tensor(0), 'log_weight': torch.tensor(log_weight)}
    state = {'nuc': {'R': R[None]}, 'elec': {k: (type(v)(*(t[None, None] for t in v))
                                                 if isinstance(v, tuple) else v[None, None])
                                             for k, v in elec.items()},
             'update_nuc_counter': torch.zeros(1, dtype=torch.long)}
    loss = create_loss_fn(hamil_t, wf, functools.partial(median_clip_and_mask, clip_width=5,
                                                         median_center=True))
    seen = {}

    class Recording:
        def step(self, opt_state, phys_conf, weight, data=None):
            (value, (E_loc, _, stats)), grads = loss.value_and_grad(phys_conf, weight)
            seen.update(phys_conf=phys_conf, weight=weight, loss=value, E_loc=E_loc,
                        grads=grads)
            return opt_state, E_loc, None, stats

    rng = np.random.default_rng(5)
    ewm, update_ewm = init_multi_mol_multi_state_ewm((1, 1))
    with pytest.MonkeyPatch.context() as mp:
        feed_draws(mp, [rng.normal(size=r.shape)], [rng.uniform(size=len(r))])
        out = train_step(None, sampler, Recording(), TrainState(state, None, None),
                         torch.tensor([0]), ewm, ewm, update_ewm)
    return log_weight, seen, out


def test_train_step_weights_the_walkers_as_jax():
    """The step weights its walkers by ``pexp_normalize_mean`` of the
    sampler's ``log_weight`` (1e-14), not by one; the step hands the
    optimizer the ``[mol, state, walker]`` grid."""
    log_weight, seen, (train_state, *_) = _weighted_step()
    want = jax_pexp_normalize_mean(jnp.asarray(log_weight), axis=-1)[None, None]
    assert_close(seen['weight'], want, 1e-14, 'weights')
    assert seen['weight'].std() > 0.3
    assert torch.equal(train_state.sampler['elec']['step'], torch.tensor([[1]]))


def test_weighted_step_with_median_clip_matches_jax():
    """The loss and gradient that step takes, on its walkers and weights, with
    ``median_clip_and_mask(clip_width=5, median_center=True)``, against JAX's
    ``create_loss_fn(...).value_and_grad`` at the tolerance of
    ``test_loss_and_gradient_match_jax`` (1e-10)."""
    log_weight, seen, _ = _weighted_step()
    hamil_j, ansatz, params, _, wf, _ = models('LiH')
    loss_j = jax_create_loss_fn(hamil_j, ansatz, functools.partial(
        jax_median_clip_and_mask, clip_width=5, median_center=True))
    r = seen['phys_conf'].r[0, 0].numpy()  # the step's grid [1, 1, B, n, 3]
    pc = jax.tree_util.tree_map(lambda x: x[None, None], jax_phys_conf(hamil_j, r))
    weight = jax_pexp_normalize_mean(jnp.asarray(log_weight), axis=-1)[None, None]
    (want_loss, (want_E, _, _)), (want_grads,) = jax.jit(loss_j.value_and_grad)(
        [params], jax.random.PRNGKey(0), (pc, weight, {}))
    assert_close(seen['loss'], want_loss, 1e-10, 'loss')
    assert_close(seen['E_loc'], np.asarray(want_E), 1e-10, 'E_loc')
    got = grads_by_jax_path(seen['grads'], wf)
    want = {(p, n): g for p, bundle in want_grads.items() for n, g in bundle.items()}
    assert set(got) == set(want)
    for key, g in want.items():
        assert_close(got[key], g, 1e-10, '/'.join(key))


def _h2(**kwargs):
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    return hamil, dqt.psiformer_ansatz(hamil, **TINY, **kwargs)


def _flat(wf):
    return torch.cat([p.detach().flatten() for p in wf.parameters()])


def test_train_and_evaluate_with_langevin_and_equilibration():
    """``decorr_langevin`` with 8 equilibration calls through both entry
    points on the CPU: the calls come first (``E_loc`` None), then finite
    steps; training changes the parameters, evaluation does not, and sampling
    leaves no ``.grad`` on them."""
    hamil, wf = _h2()
    out = list(dqt.fit.train(hamil, wf, n_walkers=16, steps=3, sampler='decorr_langevin',
                         max_eq_steps=8, eq_allow_early_stopping=False, device='cpu'))
    assert [(step, E is None) for step, _, E, _ in out] == \
        [(i, True) for i in range(8)] + [(i, False) for i in range(3)]
    for _, state, E_loc, stats in out[8:]:
        assert torch.isfinite(E_loc).all() and E_loc.shape == (16,)
        assert all(torch.isfinite(v).all() for v in stats.values())
        assert state.sampler['elec']['force'].shape == (1, 1, 16, 2, 3)
    assert out[7][1].opt is None and 'sampling/tau' in out[7][3]
    assert all(p.grad is None for p in wf.parameters())
    before = _flat(wf)
    steps = list(dqt.evaluate(hamil, wf, n_walkers=16, steps=2, sampler='decorr_langevin',
                              max_eq_steps=3, device='cpu'))
    assert [E is None for _, _, E, _ in steps] == [True] * 3 + [False] * 2
    assert all(torch.isfinite(E).all() for _, _, E, _ in steps[3:])
    assert torch.equal(_flat(wf), before)
    assert all(p.grad is None for p in wf.parameters())


def test_train_changes_the_parameters_with_langevin():
    hamil, wf = _h2()
    before = _flat(wf)
    for _, _, E_loc, _ in dqt.fit.train(hamil, wf, n_walkers=8, steps=2, device='cpu',
                                    sampler='decorr_langevin', optimizer='adam'):
        after = _flat(wf)
        assert not torch.equal(after, before) and torch.isfinite(E_loc).all()
        before = after


@pytest.mark.parametrize('name', sorted(RECIPES))
def test_train_reaches_each_recipe(name):
    hamil, wf = _h2()
    (_, state, E_loc, stats), = dqt.fit.train(hamil, wf, n_walkers=8, steps=1, sampler=name,
                                          device='cpu')
    elec = state.sampler['elec']
    assert torch.isfinite(E_loc).all() and torch.isfinite(stats['sampling/tau']).all()
    assert ('force' in elec) is (name == 'decorr_langevin')
    assert elec['age'].max() <= RECIPES[name](hamil=hamil, wf=wf).length


def test_train_takes_the_clipping_function():
    hamil, wf = _h2()
    calls = []

    def clip(x):
        calls.append(len(x))
        return median_clip_and_mask(x, clip_width=5, median_center=True)

    list(dqt.fit.train(hamil, wf, n_walkers=8, steps=2, decorr=2, clip_mask_fn=clip,
                   device='cpu'))
    assert calls == [8, 8]


def test_train_on_two_geometries_with_walker_weights():
    """Two H2 geometries, one a step (``molecule_batch_size`` 1), sampled by
    ``ResampledSampler`` (period 3) around Metropolis with ``max_age`` 20:
    each step moves one molecule's walkers only, the psi refresh moves the
    weights of both, and the EWM stats are of the molecule stepped."""
    hamil, wf = _h2()
    mols = [hamil.mol, dqt.Molecule(coords=1.2 * hamil.mol.coords, charges=hamil.mol.charges,
                                    charge=0, spin=0)]
    factory = lambda hamil, wf: chain(  # noqa: E731
        ResampledSampler(period=3), DecorrSampler(length=2),
        MetropolisSampler(hamil, wf, max_age=20))
    prev, moved = None, []
    for _, state, E_loc, stats in dqt.fit.train(hamil, wf, n_walkers=16, steps=4, sampler=factory,
                                            mols=mols, molecule_batch_size=1, device='cpu'):
        elec = state.sampler['elec']
        assert elec['r'].shape == (2, 1, 16, 2, 3) and elec['tau'].shape == (2, 1)
        assert torch.isfinite(E_loc).all() and stats['energy/ewm'].shape == (1, 1)
        assert torch.isfinite(elec['log_weight']).all() and (elec['log_weight'] <= 0).all()
        if prev is not None:
            same = [torch.equal(elec['r'][i], prev[i]) for i in range(2)]
            assert sorted(same) == [False, True]
            moved.append(same.index(False))
        prev = elec['r'].clone()
    assert moved[0] != moved[1] != moved[2]  # one pass of the shuffled pair after another
    assert (elec['log_weight'] < 0).any()


def test_train_and_evaluate_take_a_molecule_batch():
    """Two H2 geometries a step (``molecule_batch_size`` 2) under
    ``ResampledSampler``: both molecules' walkers move each step, E_loc and
    the stats carry the molecule axis, and the EWMs of both are set."""
    hamil, wf = _h2()
    mols = [hamil.mol, dqt.Molecule(coords=1.2 * hamil.mol.coords, charges=hamil.mol.charges,
                                    charge=0, spin=0)]
    factory = lambda hamil, wf: chain(  # noqa: E731
        ResampledSampler(period=3), DecorrSampler(length=2), MetropolisSampler(hamil, wf))
    prev = None
    for _, state, E_loc, stats in dqt.fit.train(hamil, wf, n_walkers=16, steps=3, sampler=factory,
                                            mols=mols, molecule_batch_size=2, device='cpu'):
        elec = state.sampler['elec']
        assert E_loc.shape == (2, 1, 16) and torch.isfinite(E_loc).all()
        assert stats['energy/ewm'].shape == (2, 1) and torch.isfinite(stats['energy/ewm']).all()
        if prev is not None:
            assert not any(torch.equal(elec['r'][i], prev[i]) for i in range(2))
        prev = elec['r'].clone()
    for _, _, E_loc, stats in dqt.evaluate(hamil, wf, n_walkers=8, steps=2, mols=mols,
                                           molecule_batch_size=2, device='cpu'):
        assert E_loc.shape == (2, 1, 8) and stats['local_energy/mean'].shape == (2, 1)
        assert torch.isfinite(E_loc).all()


def test_train_checks_its_molecules():
    hamil, wf = _h2()
    with pytest.raises(ValueError, match=r'Molecule batch size \(2\) is larger'):
        next(dqt.fit.train(hamil, wf, n_walkers=4, steps=1, molecule_batch_size=2, device='cpu'))
    other = dqt.Molecule.from_name('LiH')
    with pytest.raises(ValueError, match='charges'):
        next(dqt.fit.train(hamil, wf, n_walkers=4, steps=1, mols=[hamil.mol, other], device='cpu'))
    with pytest.raises(ValueError, match='recipe'):
        next(dqt.evaluate(hamil, wf, n_walkers=4, steps=1, sampler='langevin', device='cpu'))
