"""The port's walker weights and resampling against the JAX package at
float64: ``multinomial_resampling`` and ``pexp_normalize_mean``,
``ResampledSampler`` (the weights under a parameter change, resampling by
period and by threshold, the effective sample size), the wrap order of
``chain``, and the four sampler recipes against their YAML files.

The random draws are fed to both packages as in ``test_torch_samplers.py``
(``torch_parity.feed_draws``).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch_parity import (
    assert_close,
    assert_sampler_states,
    assert_stats,
    feed_draws,
    models,
    torch_model,
)

from deepqmc_tpu import parallel as jax_parallel
from deepqmc_tpu import utils as jax_utils
from deepqmc_tpu.sampling import electron_samplers as jax_samplers
from deepqmc_tpu.sampling import sampling_utils as jax_sampling_utils
from deepqmc_tpu_torch import parallel, utils
from deepqmc_tpu_torch.sampling import (
    RECIPES,
    DecorrSampler,
    MetropolisSampler,
    ResampledSampler,
    chain,
)

REL = 1e-12
CONF = Path(__file__).resolve().parent.parent / 'deepqmc_tpu' / 'conf' / 'task' / 'sampler_factory'


@pytest.mark.parametrize('case', ['spread', 'peaked', 'zeros'])
def test_multinomial_resampling_and_weights_match_jax(case, monkeypatch):
    rng = np.random.default_rng(7)
    log_w = {'spread': rng.normal(size=32), 'peaked': 30 * rng.normal(size=32),
             'zeros': np.zeros(32)}[case]
    u = np.concatenate([rng.uniform(size=29), [0.0, 1 - 1e-16, 0.5]])
    for axis in (None, -1):
        want = jax_parallel.pexp_normalize_mean(jnp.asarray(log_w[None]), axis=axis)
        got = parallel.pexp_normalize_mean(torch.tensor(log_w[None]), dim=axis)
        assert_close(got, want, 1e-14)
    w = np.exp(log_w - log_w.max())
    monkeypatch.setattr(jax.random, 'uniform', lambda key, shape: jnp.asarray(u))
    want = jax_utils.multinomial_resampling(jax.random.PRNGKey(0), jnp.asarray(w))
    got = utils.multinomial_resampling(torch.tensor(w), torch.tensor(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.cache
def weighted_states():
    """The LiH walkers under ``ResampledSampler.update`` after a change of the
    parameters, in both packages: (JAX state, new params; port state, new wf)."""
    hamil_j, ansatz, params, hamil_t, wf, r = models('LiH')
    rng = np.random.default_rng(2)
    params2 = {p: {k: v + 0.05 * rng.normal(size=np.shape(v)) for k, v in b.items()}
               for p, b in params.items()}
    _, wf2 = torch_model('LiH', params2)
    R_j, R_t = jnp.asarray(hamil_j.mol.coords), torch.as_tensor(hamil_t.mol.coords)
    base_j = jax_samplers.MetropolisSampler(hamil_j, ansatz.apply, tau=0.3)
    wrapped_j = jax_samplers.ResampledSampler(period=1).wrap(base_j)
    st_j = jax.jit(base_j.update)({'r': jnp.asarray(r), 'age': jnp.zeros(16, jnp.int32),
                                   'tau': jnp.asarray(0.3)}, params, R_j)
    st_j = {**st_j, 'step': jnp.array(0), 'log_weight': jnp.zeros(16)}
    st_j = jax.jit(wrapped_j.update)(st_j, params2, R_j)
    wrapped_t = ResampledSampler(period=1).wrap(MetropolisSampler(hamil_t, wf2, tau=0.3))
    with torch.no_grad():
        st_t = MetropolisSampler(hamil_t, wf, tau=0.3).update(
            {'r': torch.tensor(r), 'age': torch.zeros(16, dtype=torch.long),
             'tau': torch.tensor(0.3, dtype=torch.float64)}, R_t)
        st_t = {**st_t, 'step': torch.tensor(0),
                'log_weight': torch.zeros(16, dtype=torch.float64)}
        st_t = wrapped_t.update(st_t, R_t)
    return st_j, params2, st_t, wf2


def test_resampled_update_moves_the_weights_as_jax():
    """``update`` under changed parameters moves ``log_weight`` by twice the
    change of log|psi| and shifts its maximum to 0 (1e-12), psi refreshed."""
    st_j, _, st_t, _ = weighted_states()
    assert_sampler_states(st_t, st_j, ('r', 'psi', 'log_weight'))
    assert st_t['log_weight'].max() == 0 and st_t['log_weight'].min() < -0.1


@pytest.mark.parametrize('settings, due', [
    (dict(period=1), True),
    (dict(period=5), False),
    (dict(threshold=0.999), True),
    (dict(threshold=1e-6), False),
])
def test_resampled_sampler_matches_jax(settings, due, monkeypatch):
    """One sample call of ``ResampledSampler`` around Metropolis on weighted
    walkers: resampling when ``period`` or ``threshold`` says so (the same
    walkers drawn, ``step`` and ``log_weight`` reset), the state to 1e-12, with
    the effective sample size among the stats."""
    hamil_j, ansatz, _, hamil_t, _, r = models('LiH')
    st_j, params2, st_t, wf2 = weighted_states()
    R_j, R_t = jnp.asarray(hamil_j.mol.coords), torch.as_tensor(hamil_t.mol.coords)
    s_j = jax_samplers.ResampledSampler(**settings).wrap(
        jax_samplers.MetropolisSampler(hamil_j, ansatz.apply, tau=0.3))
    s_t = ResampledSampler(**settings).wrap(MetropolisSampler(hamil_t, wf2, tau=0.3))
    rng = np.random.default_rng(3)
    noise, u_acc, u_re = rng.normal(size=r.shape), rng.uniform(size=16), rng.uniform(size=16)
    feed_draws(monkeypatch, [noise], [u_acc, u_re])
    want, _, want_stats = jax.jit(s_j.sample)(jax.random.PRNGKey(0), st_j, params2, R_j)
    with torch.no_grad():
        got, pc, got_stats = s_t.sample(None, st_t, R_t)
    assert_sampler_states(got, want, ('r', 'psi', 'tau', 'log_weight'))
    assert got['step'].item() == int(want['step']) == (0 if due else 1)
    assert (got['log_weight'] == 0).all().item() is due
    assert_stats(got_stats, want_stats)
    assert 'sampling/effective sample size' in got_stats
    if due:  # the walkers were drawn anew: some repeated, some gone
        assert len(np.unique(np.asarray(want['r'])[:, 0, 0])) < 16
    assert torch.equal(pc.r, got['r'])


def test_chain_wraps_as_jax():
    """The first sampler of a chain is the outermost, in both packages."""
    base_t, base_j = MetropolisSampler(None, None), jax_samplers.MetropolisSampler(None, None)
    got = chain(ResampledSampler(period=3), DecorrSampler(length=2), base_t)
    want = jax_sampling_utils.chain(jax_samplers.ResampledSampler(period=3),
                                    jax_samplers.DecorrSampler(length=2), base_j)
    while hasattr(want, 'inner'):
        assert type(got).__name__ == type(want).__name__
        got, want = got.inner, want.inner
    assert got is base_t and want is base_j
    assert chain(DecorrSampler(length=4), base_t).length == 4


def _yaml_recipe(name):
    samplers = yaml.safe_load((CONF / f'{name}.yaml').read_text())['elec_sampler']['samplers']
    (decorr,), base = samplers[:-1], samplers[-1]
    kwargs = {k: v for k, v in base.items() if not k.startswith('_')}
    return decorr['length'], base['_target_'].rsplit('.', 1)[1], kwargs


@pytest.mark.parametrize('name', sorted(RECIPES))
def test_recipes_are_the_jax_sampler_factories(name):
    """Each recipe is its YAML file of ``conf/task/sampler_factory``: the
    decorrelation length, the base sampler and its settings."""
    assert {p.stem for p in CONF.glob('*.yaml')} == set(RECIPES)
    length, cls, kwargs = _yaml_recipe(name)
    sampler = RECIPES[name](hamil=None, wf=None)
    assert type(sampler).__name__ == '_Decorr' and sampler.length == length
    base = sampler.inner
    assert type(base).__name__ == cls
    defaults = MetropolisSampler(None, None)
    assert base.initial_tau == kwargs.get('tau', defaults.initial_tau)
    assert base.max_age == kwargs.get('max_age', defaults.max_age)
    assert base.target_acceptance == kwargs.get('target_acceptance', defaults.target_acceptance)
