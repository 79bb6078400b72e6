"""The optimizers of several electronic states against the JAX package at
float64, on the small PsiFormer of LiH with one parameter seed per state and
the loss of ``train_excited_psiformer.yaml`` (``alpha``, the ``max_gap_std``
scale): six KFAC steps of two states through ``KFACOptimizer`` with
``merge_keys`` (inverses refreshed at steps 0 and 3 and carried between, the
trust region binding), with per step each state's parameters, the per-state
factors and inverses, the joint trust region's scale and the stats, and the
merged parameters bitwise equal across states; the JAX state after the last
step converted (``convert.kfac_state_from_jax``) equals the port's;
``merge_states`` on its own; and two Adam steps over two states.  The
tolerances of ``tests/test_torch_kfac.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import assert_close, jax_model, jax_phys_conf, torch_model, walkers

from deepqmc_tpu.kfac import KFAC as JaxKFAC
from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import median_clip_and_mask as jax_median_clip
from deepqmc_tpu.loss import psi_ratio_clip_and_mask as jax_ratio_clip
from deepqmc_tpu.optimizer import KFACOptimizer as JaxKFACOptimizer
from deepqmc_tpu.optimizer import OptaxOptimizer
from deepqmc_tpu.optimizer import merge_states as jax_merge_states
from deepqmc_tpu.utils import ConstantSchedule as JaxConstant
from deepqmc_tpu.utils import InverseSchedule as JaxInverse
from deepqmc_tpu.utils import tree_stack, tree_unstack
from deepqmc_tpu_torch.convert import kfac_state_from_jax, state_dict_from_jax
from deepqmc_tpu_torch.loss import create_loss_fn, median_clip_and_mask, psi_ratio_clip_and_mask
from deepqmc_tpu_torch.nn import jax_param_paths
from deepqmc_tpu_torch.optimizer import AdamOptimizer, KFACOptimizer
from deepqmc_tpu_torch.types import PhysicalConfiguration
from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule
from deepqmc_tpu_torch.wf import StateStack, merge_states
from deepqmc_tpu_torch.wf.base import merged_keys

REL, REL_STEP = 1e-10, 1e-9
N_STATES, B, N_STEPS, PERIOD = 2, 8, 6, 3
MERGE = ['exponential_envelopes', 'backflow']  # a dense layer (KFAC's) among them
LOSS = dict(alpha=4.0, scale_overlap_by='max_gap_std', min_gap_scale_factor=1e-3)
CLIP = dict(clip_width=5.0, median_center=True)


@functools.cache
def _setup():
    """(JAX hamiltonian, ansatz, stacked params; the port's per-state modules
    as factories; the walkers [step, state, B, n, 3]; the EWMs of each step)."""
    hamil_j, ansatz, params = jax_model('LiH', seed=0)
    params = [params] + [jax_model('LiH', seed=s)[2] for s in range(1, N_STATES)]
    rs = np.stack([np.stack([walkers(hamil_j, 'init_sample', n=B, seed=100 * k + s)
                             for s in range(N_STATES)]) for k in range(N_STEPS)])
    rng = np.random.default_rng(0)
    ewms = [(np.array([[-8.0, -7.8]]) + 0.05 * rng.normal(size=(1, 2)),
             np.array([[0.2, 0.3]]) * rng.uniform(0.5, 1.5, size=(1, 2)))
            for _ in range(N_STEPS)]
    ewms[0] = (np.full((1, 2), np.nan), np.full((1, 2), np.nan))  # the EWMs' warm-up
    return hamil_j, ansatz, params, rs, ewms


def _stack(params):
    mods = [torch_model('LiH', p) for p in params]
    return mods[0][0], StateStack([wf for _, wf in mods])


def _jax_batch(hamil_j, r, ewm):
    pc = jax.tree_util.tree_map(lambda *x: jnp.stack(x)[None],
                                *[jax_phys_conf(hamil_j, ri) for ri in r])
    return pc, jnp.ones((1, N_STATES, B)), {'energy_ewm': jnp.asarray(ewm[0]),
                                           'std_ewm': jnp.asarray(ewm[1])}


def _port_batch(hamil_t, r, ewm):
    pc = PhysicalConfiguration(torch.as_tensor(hamil_t.mol.coords, dtype=torch.float64),
                               torch.tensor(r), torch.zeros(N_STATES, B, dtype=torch.long))
    return pc, torch.ones(N_STATES, B, dtype=torch.float64), {
        'energy_ewm': torch.tensor(ewm[0]), 'std_ewm': torch.tensor(ewm[1])}


def _assert_state_params(stack, stacked, what):
    """Each state's parameters against JAX's stacked ones."""
    for s, want in enumerate(tree_unstack(stacked)):
        paths = jax_param_paths(stack[s])
        for key, value in stack[s].state_dict().items():
            path, name = paths[key]
            assert_close(value, want[path][name], REL_STEP, f'{what}: state {s} {path}/{name}')


def _assert_kfac_state(got, want, what):
    assert got['step'] == int(want['step'])
    assert got['ema_weight'] == pytest.approx(float(want['ema_weight']), rel=1e-14)
    for key in ('factors', 'inverses'):
        assert len(got[key]) == len(want[key]) == N_STATES
        for s, (g, w) in enumerate(zip(got[key], want[key])):
            assert set(g) == set(w)
            for path, pair in w.items():
                for got_m, want_m in zip(g[path], pair):
                    assert_close(got_m, want_m, REL_STEP, f'{what}: state {s} {key} of {path}')


def test_two_state_kfac_with_merge_keys_matches_jax():
    hamil_j, ansatz, params, rs, ewms = _setup()
    hamil_t, stack = _stack(params)
    kfac_kwargs = dict(norm_constraint=1e-3, inverse_update_period=PERIOD)
    loss_j = jax_create_loss_fn(hamil_j, ansatz, functools.partial(jax_median_clip, **CLIP),
                                jax_ratio_clip, **LOSS)
    opt_j = JaxKFACOptimizer(loss_j.value_and_grad, MERGE, kfac=functools.partial(
        JaxKFAC, learning_rate_schedule=JaxInverse(0.05, 50000),
        damping_schedule=JaxConstant(1e-3), **kfac_kwargs))
    opt_j.bind_ansatz(ansatz)
    loss_t = create_loss_fn(hamil_t, stack, functools.partial(median_clip_and_mask, **CLIP),
                            psi_ratio_clip_and_mask, **LOSS)
    opt_t = KFACOptimizer(loss_t, MERGE, learning_rate_schedule=InverseSchedule(0.05, 50000),
                          damping_schedule=ConstantSchedule(1e-3), **kfac_kwargs)
    stacked = jax_merge_states(tree_stack(params), MERGE)
    merge_states(stack, MERGE)
    _assert_state_params(stack, stacked, 'merged at the start')
    rng = jax.random.PRNGKey(0)
    state_j = opt_j.init(rng, stacked, _jax_batch(hamil_j, rs[0], ewms[0]))
    state_t = opt_t.init(_port_batch(hamil_t, rs[0], ewms[0])[0])
    assert [tuple(m) for m in opt_t.kfac.metas] == [tuple(m) for m in opt_j.kfac._layer_meta]
    step_j = jax.jit(opt_j.step)
    keys = merged_keys(stack, MERGE)
    assert len(keys) == 6 and all(k.startswith(('envelope.', 'omni.backflow')) for k in keys)
    scales = []
    for step, (r, ewm) in enumerate(zip(rs, ewms)):
        stacked, state_j, E_j, ratio_j, stats_j = step_j(rng, stacked, state_j,
                                                         _jax_batch(hamil_j, r, ewm))
        state_t, E_t, ratio_t, stats_t = opt_t.step(state_t, *_port_batch(hamil_t, r, ewm))
        what = f'step {step}'
        _assert_state_params(stack, stacked, what)
        assert_close(E_t, np.asarray(E_j)[0], REL, f'{what}: E_loc')
        assert_close(ratio_t, np.asarray(ratio_j)[0], REL, f'{what}: psi ratio')
        assert set(stats_t) == set(stats_j) - {'hamil/V_nl'}
        for k, v in stats_t.items():
            assert_close(v, stats_j[k], REL_STEP, f'{what}: {k}')
        _assert_kfac_state(state_t, jax.device_get(state_j), what)
        for k in keys:
            assert torch.equal(stack[0].state_dict()[k], stack[1].state_dict()[k]), k
        scales.append(stats_t['opt/norm_scale'].item())
    assert min(scales) < 1.0  # the joint trust region binds
    # inverses refreshed at steps 0 and 3 only: JAX's state converted is the port's
    converted = kfac_state_from_jax(jax.device_get(state_j), opt_t.kfac.metas, stack)
    _assert_kfac_state(converted, jax.device_get(state_j), 'converted')
    for k, v in state_dict_from_jax(jax.device_get(stacked), stack).items():
        assert_close(v, stack.state_dict()[k], REL_STEP, f'converted {k}')


def test_merge_states_matches_jax():
    """The bundles whose path holds a merge key are averaged over the states,
    bitwise equal across them; the others keep each state's values."""
    _, _, params, _, _ = _setup()
    _, stack = _stack(params)
    before = {k: v.clone() for k, v in stack.state_dict().items()}
    want = jax_merge_states(tree_stack(params), MERGE)
    merge_states(stack, MERGE)
    _assert_state_params(stack, want, 'merged')
    keys = merged_keys(stack, MERGE)
    for k in stack[0].state_dict():
        same = torch.equal(stack[0].state_dict()[k], stack[1].state_dict()[k])
        assert same == (k in keys), k
        if k not in keys:
            assert torch.equal(stack.state_dict()[f'0.{k}'], before[f'0.{k}'])
    merge_states(stack, None)  # no keys: nothing moves
    _assert_state_params(stack, want, 'merged once')


def test_adam_over_states_matches_jax():
    hamil_j, ansatz, params, rs, ewms = _setup()
    hamil_t, stack = _stack(params)
    loss_j = jax_create_loss_fn(hamil_j, ansatz, functools.partial(jax_median_clip, **CLIP),
                                jax_ratio_clip, **LOSS)
    opt_j = OptaxOptimizer(loss_j.value_and_grad, optax_opt=optax.adam(1e-3))
    opt_t = AdamOptimizer(create_loss_fn(hamil_t, stack, functools.partial(
        median_clip_and_mask, **CLIP), psi_ratio_clip_and_mask, **LOSS), lr=1e-3)
    rng = jax.random.PRNGKey(0)
    stacked = tree_stack(params)
    state_j = opt_j.init(rng, stacked, _jax_batch(hamil_j, rs[0], ewms[0]))
    state_t = opt_t.init(None)
    step_j = jax.jit(opt_j.step)
    for step in range(2):
        stacked, state_j, E_j, _, stats_j = step_j(rng, stacked, state_j,
                                                   _jax_batch(hamil_j, rs[step], ewms[step]))
        state_t, E_t, _, stats_t = opt_t.step(state_t, *_port_batch(hamil_t, rs[step],
                                                                    ewms[step]))
        _assert_state_params(stack, stacked, f'Adam step {step}')
        assert_close(E_t, np.asarray(E_j)[0], REL, 'E_loc')
        for k in ('opt/param_norm', 'opt/grad_norm', 'opt/update_norm'):
            assert_close(stats_t[k], stats_j[k], REL_STEP, k)
