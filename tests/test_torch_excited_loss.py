"""The excited states' loss terms of the port against the JAX package at
float64, on the small PsiFormer and the small ``default`` preset with JAX's
parameters (one seed per state) and the same walkers: the local S^2 of
``physics.evaluate_spin`` (H2, LiH, and triplet H2 with no down electron),
``psi_ratio_clip_and_mask``, the overlap penalty's gradient scale (all four
``scale`` options on EWMs with NaN entries), and the whole loss of 2 and 3
states (with the penalty's ratios and overlap matrix), its stats and every
state's gradient, with ``alpha``,
``spin_penalty`` and ``sort_states_by='energy'`` on EWMs whose order is not
the identity.  At one state the cotangent transposed by autograd is held to
the closed form.  Tolerances: 1e-10 relative to each quantity's largest
entry (1e-12 for the pure array functions)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_close,
    grads_by_jax_path,
    jax_model,
    jax_phys_conf,
    jit_once,
    torch_model,
    torch_phys_conf,
    walkers,
)

from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import median_clip_and_mask as jax_median_clip
from deepqmc_tpu.loss import psi_ratio_clip_and_mask as jax_ratio_clip
from deepqmc_tpu.loss.overlap import OverlapPenalty as JaxOverlapPenalty
from deepqmc_tpu.physics import evaluate_spin as jax_evaluate_spin
from deepqmc_tpu_torch.loss import OverlapPenalty, create_loss_fn, median_clip_and_mask
from deepqmc_tpu_torch.loss import psi_ratio_clip_and_mask
from deepqmc_tpu_torch.loss.clip import clip_local_energy
from deepqmc_tpu_torch.physics import evaluate_spin
from deepqmc_tpu_torch.wf import StateStack

REL, REL_ARRAY = 1e-10, 1e-12
B = 8


@functools.cache
def _states(mol: str, preset: str, n_states: int):
    """(JAX hamiltonian, ansatz, per-state params; port hamiltonian, stack),
    state s with the parameters of seed s."""
    hamil_j, ansatz, params = jax_model(mol, seed=0, preset=preset)
    params = [params] + [jax_model(mol, seed=s, preset=preset)[2] for s in range(1, n_states)]
    wfs = [torch_model(mol, p, preset=preset) for p in params]
    return hamil_j, ansatz, params, wfs[0][0], StateStack([wf for _, wf in wfs])


def _state_walkers(hamil_j, n_states: int) -> np.ndarray:
    return np.stack([walkers(hamil_j, 'init_sample', n=B, seed=11 + s) for s in range(n_states)])


def _jax_grid(hamil_j, rs):
    """The JAX ``[1, S, B]`` configuration of the walkers ``rs`` ``[S, B, n, 3]``."""
    pcs = [jax_phys_conf(hamil_j, r) for r in rs]
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x)[None], *pcs)


def _port_grid(hamil_t, rs):
    pc = torch_phys_conf(hamil_t, rs[0])
    return pc.replace(r=torch.tensor(rs), mol_idx=torch.zeros(rs.shape[:2], dtype=torch.long))


@pytest.mark.parametrize('mol,preset', [('H2', 'psiformer'), ('H2_triplet', 'psiformer'),
                                        ('LiH', 'default')])
def test_evaluate_spin_matches_jax(mol, preset):
    """S^2_loc per walker in chunks of 5 configurations (so a walker's swaps
    straddle two forwards); with no down electron the constant S(S+1)."""
    hamil_j, ansatz, (params,), hamil_t, stack = _states(mol, preset, 1)
    r = walkers(hamil_j, 'init_sample', n=B, seed=3)
    want = jit_once(jax.vmap(jax_evaluate_spin(hamil_j, ansatz.apply), (None, 0)))(
        params, jax_phys_conf(hamil_j, r))
    with torch.no_grad():
        got = evaluate_spin(hamil_t, stack[0], torch_phys_conf(hamil_t, r), chunk=5)
    assert_close(got, want, REL, f'{mol} S^2')
    if hamil_t.n_down == 0:
        assert torch.equal(got, torch.full((B,), 2.0, dtype=torch.float64))


@pytest.mark.parametrize('exclude_width', [np.inf, 3.0])
def test_psi_ratio_clip_and_mask_matches_jax(exclude_width):
    x = np.random.default_rng(0).standard_cauchy(size=257)
    want, want_mask = jax_ratio_clip(jnp.asarray(x), clip_width=2.0, exclude_width=exclude_width)
    got, got_mask = psi_ratio_clip_and_mask(torch.tensor(x), clip_width=2.0,
                                            exclude_width=exclude_width)
    assert_close(got, want, REL_ARRAY, 'clipped ratios')
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert (~got_mask).any() == np.isfinite(exclude_width)


def _ewm_data(n_states, nan_at=()):
    """EWMs [1, S] in a non-monotonic order, with NaN (warm-up) at ``nan_at``."""
    e = np.array([-7.9, -8.05, -7.6][:n_states])[None]
    std = np.array([0.3, 0.02, 0.9][:n_states])[None]
    for i in nan_at:
        e[0, i] = std[0, i] = np.nan
    return e, std


@pytest.mark.parametrize('scale', [None, 'energy_gap', 'energy_std', 'max_gap_std'])
def test_gradient_scale_matches_jax(scale):
    e, std = _ewm_data(3, nan_at=(1,))
    want = JaxOverlapPenalty(scale, 0.05).gradient_scale(
        {'energy_ewm': jnp.asarray(e), 'std_ewm': jnp.asarray(std)})
    got = OverlapPenalty(scale, 0.05).gradient_scale(
        {'energy_ewm': torch.tensor(e), 'std_ewm': torch.tensor(std)})
    assert_close(got, want, REL_ARRAY, f'gradient scale {scale}')


# (preset, states, loss options, NaN EWM states): three states with an EWM in
# its warm-up; two with train_excited_psiformer.yaml's overlap options; both
# with the spin penalty and the states sorted by energy (the two-state
# PsiFormer without them is in tests/test_torch_excited_kfac.py)
LOSS_CASES = {
    'psiformer-3-spin-sorted': ('psiformer', 3, dict(alpha=2.0, spin_penalty=0.5,
                                                     sort_states_by='energy',
                                                     scale_overlap_by='energy_gap'), (2,)),
    'default-2-spin-sorted': ('default', 2, dict(alpha=4.0, spin_penalty=1.0,
                                                 sort_states_by='energy',
                                                 scale_overlap_by='max_gap_std',
                                                 min_gap_scale_factor=1e-3), ()),
}


@pytest.mark.parametrize('case', list(LOSS_CASES))
def test_loss_and_gradient_match_jax(case):
    preset, n_states, options, nan_at = LOSS_CASES[case]
    hamil_j, ansatz, params, hamil_t, stack = _states('LiH', preset, n_states)
    rs = _state_walkers(hamil_j, n_states)
    weight = np.random.default_rng(2).uniform(0.5, 1.5, size=(n_states, B))
    e, std = _ewm_data(n_states, nan_at)
    if options.get('sort_states_by'):
        assert not (np.argsort(e[0]) == np.arange(n_states)).all()
    clip = dict(clip_width=5.0, median_center=True)
    loss_j = jax_create_loss_fn(hamil_j, ansatz, functools.partial(jax_median_clip, **clip),
                                jax_ratio_clip, **options)
    loss_t = create_loss_fn(hamil_t, stack, functools.partial(median_clip_and_mask, **clip),
                            psi_ratio_clip_and_mask, **options)
    data_j = {'energy_ewm': jnp.asarray(e), 'std_ewm': jnp.asarray(std)}
    (want_loss, (want_E, want_ratio, want_stats)), want_grads = jax.jit(loss_j.value_and_grad)(
        params, jax.random.PRNGKey(0), (_jax_grid(hamil_j, rs), jnp.asarray(weight)[None], data_j))
    data_t = {'energy_ewm': torch.tensor(e), 'std_ewm': torch.tensor(std)}
    (loss, (E, ratio, stats)), grads = loss_t.value_and_grad(
        _port_grid(hamil_t, rs), torch.tensor(weight), data_t)
    assert_close(loss, want_loss, REL, 'loss')
    assert_close(E, np.asarray(want_E)[0], REL, 'E_loc')
    assert_close(ratio, np.asarray(want_ratio)[0], REL, 'psi ratio')
    want_stats.pop('hamil/V_nl')  # all-electron: no ECP term
    assert set(stats) == set(want_stats)
    for k, v in want_stats.items():
        assert_close(stats[k], v, REL, k)
    assert len(grads) == n_states
    for s, (g_t, g_j) in enumerate(zip(grads, want_grads)):
        got = grads_by_jax_path(g_t, stack[s])
        want = {(p, n): g for p, bundle in g_j.items() for n, g in bundle.items()}
        assert set(got) == set(want)
        for key, g in want.items():
            assert_close(got[key], g, REL, f'state {s}: ' + '/'.join(key))


@pytest.mark.parametrize('preset', ['psiformer', 'default'])
def test_transposed_cotangent_is_the_closed_form_at_one_state(preset):
    """One state, no spin penalty: the per-walker coefficients that autograd
    transposes from the assembled tangent equal the closed form, to rounding."""
    hamil_j, _, _, hamil_t, stack = _states('LiH', preset, 1)
    r = walkers(hamil_j, 'init_sample', n=B, seed=5)
    loss = create_loss_fn(hamil_t, stack[0], functools.partial(
        median_clip_and_mask, clip_width=2.0, median_center=True))
    weight = torch.tensor(np.random.default_rng(3).uniform(0.5, 1.5, size=B))
    terms = loss.terms(torch_phys_conf(hamil_t, r), weight)
    closed = loss.cotangent(weight, terms)
    clipped, mask = clip_local_energy(loss.clip_mask_fn, terms.local_energy)
    transposed = loss.transposed_cotangent(clipped, mask, weight[None, None], terms)
    assert_close(transposed, closed, 1e-14, 'cotangent')
    assert (closed != 0).all()
