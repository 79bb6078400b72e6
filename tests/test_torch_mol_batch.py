"""Several molecules a step against the JAX package at float64, on the small
PsiFormer of LiH (kernels 1 and 2 through their plain versions) and two of
its geometries: the loss, its gradient and stats on a ``[2, 1, B]`` grid
(weighted walkers), the same with two electronic states on ``[2, 2, B]``
(the overlap penalty per molecule), and one KFAC update on the molecule
batch (``tests/test_torch_mol_batch_fit.py`` has the fit loop and
pretraining).  Each state's walkers of both molecules go through one forward
Laplacian pass with the nuclei per walker.  The tolerances of the excited
states' tests: 1e-10 for the loss and gradient, 1e-9 after an update."""

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
    torch_model,
    walkers,
)

import deepqmc_tpu as dqj
from deepqmc_tpu.kfac import KFAC as JaxKFAC
from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import median_log_squeeze_and_mask as jax_clip
from deepqmc_tpu.loss import psi_ratio_clip_and_mask as jax_ratio_clip
from deepqmc_tpu.types import PhysicalConfiguration as JaxConf
from deepqmc_tpu.utils import ConstantSchedule as JaxConstant
from deepqmc_tpu.utils import InverseSchedule as JaxInverse
from deepqmc_tpu_torch.kfac import KFAC
from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
from deepqmc_tpu_torch.loss import psi_ratio_clip_and_mask
from deepqmc_tpu_torch.nn import jax_param_paths
from deepqmc_tpu_torch.types import PhysicalConfiguration
from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule
from deepqmc_tpu_torch.wf import StateStack

REL, REL_STEP = 1e-10, 1e-9
B = 8
SCALES = (1.0, 1.15, 0.9)  # the geometries: LiH's bond stretched by these
LOSS = dict(alpha=4.0, scale_overlap_by='max_gap_std', min_gap_scale_factor=1e-3)


def _geometries(package, hamil, n):
    mol = hamil.mol
    return [package.Molecule(coords=s * np.asarray(mol.coords), charges=mol.charges,
                             charge=mol.charge, spin=mol.spin) for s in SCALES[:n]]


@functools.cache
def _setup(n_states: int):
    """(JAX hamiltonian, ansatz, per-state params; the walkers [mol, state,
    B, n, 3] around each of two geometries, their nuclei [mol, n_nuc, 3],
    weights [mol, state, B] and EWMs [mol, state])."""
    hamil_j, ansatz, params = jax_model('LiH', seed=0)
    params = [params] + [jax_model('LiH', seed=s)[2] for s in range(1, n_states)]
    R = np.stack([m.coords for m in _geometries(dqj, hamil_j, 2)])
    r = np.stack([np.stack([walkers(hamil_j, 'init_sample', n=B, seed=10 * i + s) * SCALES[i]
                            for s in range(n_states)]) for i in range(2)])
    rng = np.random.default_rng(1)
    weight = rng.uniform(0.5, 1.5, size=r.shape[:3])
    ewm = (np.array([[-8.0, -7.8], [-7.9, -7.7]])[:, :n_states],
           np.array([[0.2, 0.3], [0.25, 0.35]])[:, :n_states])
    return hamil_j, ansatz, params, R, r, weight, ewm


def _port_wf(params):
    mods = [torch_model('LiH', p) for p in params]
    return mods[0][0], (mods[0][1] if len(mods) == 1 else StateStack([wf for _, wf in mods]))


def _jax_batch(R, r, weight, ewm):
    m, S = r.shape[:2]
    Rs = np.broadcast_to(R[:, None, None], (m, S, B, *R.shape[1:]))
    pc = JaxConf(jnp.asarray(Rs), jnp.asarray(r), jnp.zeros((m, S, B), jnp.int32))
    return pc, jnp.asarray(weight), {'energy_ewm': jnp.asarray(ewm[0]),
                                     'std_ewm': jnp.asarray(ewm[1])}


def _port_batch(R, r, weight, ewm):
    m, S = r.shape[:2]
    pc = PhysicalConfiguration(torch.tensor(R), torch.tensor(r),
                               torch.arange(m)[:, None, None].expand(m, S, B).clone())
    return pc, torch.tensor(weight), {'energy_ewm': torch.tensor(ewm[0]),
                                      'std_ewm': torch.tensor(ewm[1])}


def _losses(n_states):
    hamil_j, ansatz, params, R, r, weight, ewm = _setup(n_states)
    hamil_t, wf = _port_wf(params)
    extra_j = (jax_ratio_clip,) if n_states > 1 else ()
    extra_t = (psi_ratio_clip_and_mask,) if n_states > 1 else ()
    kw = LOSS if n_states > 1 else {}
    loss_j = jax_create_loss_fn(hamil_j, ansatz, jax_clip, *extra_j, **kw)
    loss_t = create_loss_fn(hamil_t, wf, median_log_squeeze_and_mask, *extra_t, **kw)
    return (loss_j, params, _jax_batch(R, r, weight, ewm)), (loss_t, wf,
                                                            _port_batch(R, r, weight, ewm))


@pytest.mark.parametrize('n_states', [1, 2])
def test_loss_and_gradient_on_a_molecule_batch_match_jax(n_states):
    """The loss, E_loc ``[2, S, B]``, the ratios ``[2, S, S, B]``, the stats
    ``[2, S]`` and each state's gradient against JAX's ``value_and_grad``."""
    (loss_j, params, batch_j), (loss_t, wf, batch_t) = _losses(n_states)
    (want_loss, (want_E, want_ratio, want_stats)), want_grads = jax.jit(
        loss_j.value_and_grad)(params, jax.random.PRNGKey(0), batch_j)
    (loss, (E, ratio, stats)), grads = loss_t.value_and_grad(*batch_t)
    assert_close(loss, want_loss, REL, 'loss')
    assert tuple(E.shape) == (2, n_states, B)
    assert_close(E, want_E, REL, 'E_loc')
    if n_states > 1:
        assert tuple(ratio.shape) == (2, n_states, n_states, B)
        assert_close(ratio, want_ratio, REL, 'psi ratio')
    else:
        assert ratio is None
    for k, v in stats.items():
        assert_close(v, want_stats[k], REL, k)
    assert set(stats) == set(want_stats) - {'hamil/V_nl'}
    states = wf if n_states > 1 else [wf]
    grads = grads if n_states > 1 else [grads]
    for s, (state, g) in enumerate(zip(states, grads)):
        got = grads_by_jax_path(g, state)
        want = {(p, n): x for p, bundle in want_grads[s].items() for n, x in bundle.items()}
        assert set(got) == set(want)
        for key, x in want.items():
            assert_close(got[key], x, REL, f'state {s} ' + '/'.join(key))


def test_kfac_update_on_a_molecule_batch_matches_jax():
    """One KFAC step on the ``[2, 1, B]`` grid: the factor sums over both
    molecules normalised by 2B, the parameters after the update, the stats."""
    (loss_j, params, batch_j), (loss_t, wf, batch_t) = _losses(1)
    kwargs = dict(norm_constraint=1e-3, inverse_update_period=5)
    kfac_j = JaxKFAC(loss_j.value_and_grad, learning_rate_schedule=JaxInverse(0.05, 10000),
                     damping_schedule=JaxConstant(1e-3), **kwargs)
    kfac_j.bind_ansatz(loss_j.ansatz)
    kfac_t = KFAC(loss_t, learning_rate_schedule=InverseSchedule(0.05, 10000),
                  damping_schedule=ConstantSchedule(1e-3), **kwargs)
    rng = jax.random.PRNGKey(0)
    state_j = kfac_j.init(rng, params, batch_j)
    state_t = kfac_t.init(batch_t[0])
    (params_j,), state_j, (E_j, _, _), stats_j = jax.jit(kfac_j.step)(rng, params, state_j,
                                                                      batch_j)
    state_t, (E_t, _, _), stats_t = kfac_t.step(state_t, batch_t[0], batch_t[1])
    assert_close(E_t, E_j, REL, 'E_loc')
    for key in ('opt/norm_scale', 'opt/v_dot_g', 'opt/grad_norm', 'opt/update_norm'):
        assert_close(stats_t[key], stats_j[key], REL_STEP, key)
    state_j = jax.device_get(state_j)
    for path, pair in state_j['factors'][0].items():
        for got, want in zip(state_t['factors'][path], pair):
            assert_close(got, want, REL_STEP, f'factor of {path}')
    paths = jax_param_paths(wf)
    for key, value in wf.state_dict().items():
        path, name = paths[key]
        assert_close(value, params_j[path][name], REL_STEP, f'{path}/{name}')
