"""Training the port's FermiNet and ``default`` ansätze against the JAX
package at float64, the small presets with JAX's parameters and the same
walkers: the VMC loss built as ``conf/task/train.yaml`` builds it (``alpha``
and a ``clip_mask_overlap_fn``, read only with several electronic states),
two KFAC steps (inverses refreshed, then carried) with the dense layers each
side discovers, the factors and inverses, and two Adam steps; the
tolerances of ``test_torch_kfac.py`` and ``test_torch_train.py``."""

import jax
import numpy as np
import optax
import pytest
import torch
from torch_parity import (
    assert_close,
    grads_by_jax_path,
    jax_batch,
    jax_model,
    torch_model,
    torch_phys_conf,
    walkers,
)

from deepqmc_tpu.kfac import KFAC as JaxKFAC
from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import median_log_squeeze_and_mask as jax_clip
from deepqmc_tpu.loss import psi_ratio_clip_and_mask
from deepqmc_tpu.optimizer import OptaxOptimizer
from deepqmc_tpu.utils import ConstantSchedule as JaxConstant
from deepqmc_tpu.utils import InverseSchedule as JaxInverse
from deepqmc_tpu.utils import tree_stack, tree_unstack
from deepqmc_tpu_torch.kfac import KFAC
from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
from deepqmc_tpu_torch.nn import jax_param_paths
from deepqmc_tpu_torch.optimizer import AdamOptimizer
from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule

REL, REL_STEP = 1e-10, 1e-9
N_STEPS, B = 2, 8


def _models(preset, full_determinant=True, mol='LiH'):
    over = {'full_determinant': full_determinant}
    hamil_j, ansatz, params = jax_model(mol, preset=preset, **over)
    hamil_t, wf = torch_model(mol, params, preset=preset, overrides=over)
    rs = [walkers(hamil_j, 'init_sample', n=B, seed=10 * k) for k in range(N_STEPS)]
    return (hamil_j, ansatz, params), (hamil_t, wf), rs


def _overlap_clip_never_called(psi_ratio):
    raise AssertionError('the overlap clip ran with one electronic state')


def _assert_params(wf, want, what):
    paths = jax_param_paths(wf)
    for key, value in wf.state_dict().items():
        path, name = paths[key]
        assert_close(value, want[path][name], REL_STEP, f'{what}: {path}/{name}')


@pytest.mark.parametrize('preset', ['default', 'ferminet'])
def test_loss_with_overlap_options_matches_jax(preset):
    """``alpha=4.0`` and a ``clip_mask_overlap_fn`` as ``train.yaml`` gives
    them: stored, never called with one state; the loss, its stats and the
    gradient as JAX's."""
    (hamil_j, ansatz, params), (hamil_t, wf), (r, _) = _models(preset)
    loss_j = jax_create_loss_fn(hamil_j, ansatz, jax_clip, psi_ratio_clip_and_mask, alpha=4.0)
    loss_t = create_loss_fn(hamil_t, wf, median_log_squeeze_and_mask,
                            clip_mask_overlap_fn=_overlap_clip_never_called, alpha=4.0)
    assert loss_t.alpha == 4.0 and loss_t.clip_mask_overlap_fn is _overlap_clip_never_called
    (want_loss, (want_E, _, want_stats)), (want_grads,) = jax.jit(loss_j.value_and_grad)(
        [params], jax.random.PRNGKey(0), jax_batch(hamil_j, r))
    (loss, (E, ratio, stats)), grads = loss_t.value_and_grad(
        torch_phys_conf(hamil_t, r), torch.ones(B, dtype=torch.float64))
    assert ratio is None
    assert_close(loss, want_loss, REL, 'loss')
    assert_close(E, np.asarray(want_E)[0, 0], REL, 'E_loc')
    want_stats.pop('hamil/V_nl')  # all-electron: no ECP term
    assert set(stats) == set(want_stats)
    for k, v in want_stats.items():
        assert_close(stats[k], np.asarray(v)[0, 0], REL, k)
    got = grads_by_jax_path(grads, wf)
    want = {(p, n): g for p, bundle in want_grads.items() for n, g in bundle.items()}
    assert set(got) == set(want)
    for key, g in want.items():
        assert_close(got[key], g, REL, '/'.join(key))
    assert all(torch.count_nonzero(g) for g in grads.values())


def test_spin_penalty_still_raises():
    """The spin penalty is ported (``tests/test_torch_excited_loss.py``); with
    several states the loss still raises without the overlap options."""
    from deepqmc_tpu_torch.wf import StateStack

    stack = StateStack([torch.nn.Linear(1, 1), torch.nn.Linear(1, 1)])
    with pytest.raises(ValueError, match='alpha and clip_mask_overlap_fn'):
        create_loss_fn(None, stack, median_log_squeeze_and_mask, spin_penalty=1.0)


@pytest.mark.parametrize('preset', ['default', 'ferminet'])
def test_kfac_steps_match_jax(preset):
    """KFAC as ``opt/kfac.yaml`` with the inverses refreshed every 2 steps:
    the layers (the shared two-particle net ``u`` one layer over every edge,
    the ``default`` preset's ``conf_coeff`` a dense layer of one row),
    then per step the parameters, E_loc, the stats, the factors and the
    inverses."""
    (hamil_j, ansatz, params), (hamil_t, wf), rs = _models(preset)
    kw = dict(norm_constraint=1e-3, inverse_update_period=2)
    kfac_j = JaxKFAC(jax_create_loss_fn(hamil_j, ansatz, jax_clip).value_and_grad,
                     learning_rate_schedule=JaxInverse(0.05, 10000),
                     damping_schedule=JaxConstant(1e-3), **kw)
    kfac_j.bind_ansatz(ansatz)
    kfac_t = KFAC(create_loss_fn(hamil_t, wf, median_log_squeeze_and_mask),
                  learning_rate_schedule=InverseSchedule(0.05, 10000),
                  damping_schedule=ConstantSchedule(1e-3), **kw)
    batches = [jax_batch(hamil_j, r) for r in rs]
    pcs = [torch_phys_conf(hamil_t, r) for r in rs]
    rng = jax.random.PRNGKey(0)
    state_j = kfac_j.init(rng, [params], batches[0])
    state_t = kfac_t.init(pcs[0])
    assert [tuple(m) for m in kfac_t.metas] == [tuple(m) for m in kfac_j._layer_meta]
    u = [m for m in kfac_t.metas if m.path.endswith('electron_gnnlayer/u/linear_0')]
    assert len(u) == 1 and u[0].n_calls == 1
    if preset == 'default':
        (conf,) = [m for m in kfac_t.metas if m.path.endswith('/conf_coeff')]
        assert conf.repeats == (1,) and not conf.has_bias
    step_j = jax.jit(kfac_j.step)
    for step, (batch, pc) in enumerate(zip(batches, pcs)):
        (params,), state_j, (E_j, _, _), stats_j = step_j(rng, [params], state_j, batch)
        state_t, (E_t, _, _), stats_t = kfac_t.step(state_t, pc, torch.ones(B,
                                                                             dtype=torch.float64))
        what = f'{preset} step {step}'
        _assert_params(wf, params, what)
        assert_close(E_t, np.asarray(E_j)[0, 0], REL, f'{what}: E_loc')
        assert set(stats_t) == set(stats_j)
        for k, v in stats_j.items():
            assert_close(stats_t[k], v, REL_STEP, f'{what}: {k}')
        for key in ('factors', 'inverses'):
            want = state_j[key][0]
            assert set(state_t[key]) == set(want)
            for path, pair in want.items():
                for got_m, want_m in zip(state_t[key][path], pair):
                    assert_close(got_m, want_m, REL_STEP, f'{what}: {key} of {path}')


@pytest.mark.parametrize('preset, full_determinant', [('default', True), ('ferminet', False)],
                         ids=['default-full', 'ferminet-split'])
def test_adam_steps_match_jax(preset, full_determinant):
    """Two Adam steps (lr 1e-3) against ``OptaxOptimizer`` with ``optax.adam``."""
    (hamil_j, ansatz, params), (hamil_t, wf), rs = _models(preset, full_determinant)
    opt_j = OptaxOptimizer(jax_create_loss_fn(hamil_j, ansatz, jax_clip).value_and_grad,
                           optax_opt=optax.adam(1e-3))
    opt_t = AdamOptimizer(create_loss_fn(hamil_t, wf, median_log_squeeze_and_mask), lr=1e-3)
    rng = jax.random.PRNGKey(0)
    stacked = tree_stack([params])
    state_j = opt_j.init(rng, stacked, jax_batch(hamil_j, rs[0]))
    state_t = opt_t.init(torch_phys_conf(hamil_t, rs[0]))
    step_j = jax.jit(opt_j.step)
    for step, r in enumerate(rs):
        stacked, state_j, E_j, _, stats_j = step_j(rng, stacked, state_j, jax_batch(hamil_j, r))
        state_t, E_t, _, stats_t = opt_t.step(state_t, torch_phys_conf(hamil_t, r),
                                              torch.ones(B, dtype=torch.float64))
        _assert_params(wf, tree_unstack(stacked)[0], f'{preset} step {step}')
        assert_close(E_t, np.asarray(E_j)[0, 0], REL, 'E_loc')
        for k in ('opt/param_norm', 'opt/grad_norm', 'opt/update_norm'):
            assert_close(stats_t[k], stats_j[k], REL_STEP, k)
