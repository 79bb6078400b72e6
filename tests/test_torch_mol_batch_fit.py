"""Several molecules a step against the JAX package at float64, on the small
PsiFormer of LiH and two or three of its geometries (the walkers and helpers
of ``tests/test_torch_mol_batch.py``): three steps of ``fit_wf`` with
``molecule_batch_size`` 2 over three geometries fed the same draws (the
per-molecule EWMs and the parameters), and one pretraining step on two
geometries at once, each held to its own SCF orbitals.  1e-10 for the
losses, 1e-9 after an update."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mol_batch import (
    B,
    REL,
    REL_STEP,
    SCALES,
    _geometries,
    _port_batch,
    _port_wf,
    _setup,
)
from torch_parity import assert_close, feed_draws, walkers

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt
from deepqmc_tpu.fit import fit_wf as jax_fit_wf
from deepqmc_tpu.kfac import KFAC as JaxKFAC
from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import median_log_squeeze_and_mask as jax_clip
from deepqmc_tpu.optimizer import KFACOptimizer as JaxKFACOptimizer
from deepqmc_tpu.sampling import DecorrSampler as JaxDecorr
from deepqmc_tpu.sampling import MetropolisSampler as JaxMetropolis
from deepqmc_tpu.sampling import chain as jax_chain
from deepqmc_tpu.sampling import initialize_sampling as jax_initialize_sampling
from deepqmc_tpu.types import PhysicalConfiguration as JaxConf
from deepqmc_tpu.types import TrainState as JaxTrainState
from deepqmc_tpu.utils import ConstantSchedule as JaxConstant
from deepqmc_tpu.utils import InverseSchedule as JaxInverse
from deepqmc_tpu.utils import tree_stack
from deepqmc_tpu_torch.fit import TrainState, fit_wf
from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
from deepqmc_tpu_torch.nn import jax_param_paths
from deepqmc_tpu_torch.optimizer import KFACOptimizer
from deepqmc_tpu_torch.sampling import DecorrSampler, MetropolisSampler, chain, initialize_sampling
from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule


class _Batches:
    """A molecule-index sampler giving fixed batches in turn (JAX's ``fit_wf``
    draws one more at its start, for the optimizer's initialisation)."""

    def __init__(self, n_mols, batches, xp):
        self.n_mols, self.batches, self.xp = n_mols, list(batches), xp

    def sample(self):
        return self.xp(self.batches.pop(0))


def test_fit_wf_on_a_molecule_batch_matches_jax(monkeypatch):
    """Three KFAC steps of ``fit_wf``, two of three geometries a step
    ([0, 1], [2, 0], [1, 2]), Metropolis with the same draws: E_loc and the
    energy EWM of each molecule a step touched, and the parameters after."""
    hamil_j, ansatz, params, _, _, _, _ = _setup(1)
    hamil_t, wf = _port_wf(params)
    params = params[0]
    mols_j, mols_t = _geometries(dqj, hamil_j, 3), _geometries(dqt, hamil_t, 3)
    R = np.stack([m.coords for m in mols_j])
    rs = np.stack([walkers(hamil_j, 'init_sample', n=B, seed=20 + i) * s
                   for i, s in enumerate(SCALES)])[:, None]
    steps = [[0, 1], [2, 0], [1, 2]]
    opt_kwargs = dict(norm_constraint=1e-3, inverse_update_period=5)

    _, smpl_j = jax_initialize_sampling(
        jax.random.PRNGKey(0), hamil_j, ansatz, mols_j, 1, 2,
        elec_sampler=lambda hamil, wf: jax_chain(JaxDecorr(length=1), JaxMetropolis(hamil, wf)))
    stacked = tree_stack([params])
    state_j = jax.jit(smpl_j.update)({
        'nuc': {'R': jnp.asarray(R)},
        'elec': {'r': jnp.asarray(rs), 'age': jnp.zeros(rs.shape[:3], jnp.int32),
                 'tau': jnp.ones((3, 1))},
        'update_nuc_counter': jnp.zeros(3),
    }, stacked)
    _, smpl_t = initialize_sampling(
        torch.Generator().manual_seed(0), hamil_t, wf, mols_t, 1, 2,
        elec_sampler=lambda hamil, wf: chain(DecorrSampler(length=1), MetropolisSampler(hamil,
                                                                                        wf)))
    with torch.no_grad():
        state_t = smpl_t.update({
            'nuc': {'R': torch.tensor(R)},
            'elec': {'r': torch.tensor(rs), 'age': torch.zeros(rs.shape[:3], dtype=torch.long),
                     'tau': torch.ones(3, 1, dtype=torch.float64)},
            'update_nuc_counter': torch.zeros(3, dtype=torch.long),
        })
    rng = np.random.default_rng(3)
    feed_draws(monkeypatch, [rng.normal(size=rs.shape[2:])], [rng.uniform(size=B)])

    want = list(jax_fit_wf(
        jax.random.PRNGKey(1), hamil_j, ansatz,
        functools.partial(JaxKFACOptimizer, kfac=functools.partial(
            JaxKFAC, learning_rate_schedule=JaxInverse(0.05, 10000),
            damping_schedule=JaxConstant(1e-3), **opt_kwargs)),
        _Batches(3, [steps[0], *steps], jnp.asarray), smpl_j, range(3),
        JaxTrainState(state_j, stacked, None), functools.partial(
            jax_create_loss_fn, clip_mask_fn=jax_clip), []))
    got = list(fit_wf(
        None, hamil_t, wf, functools.partial(
            KFACOptimizer, learning_rate_schedule=InverseSchedule(0.05, 10000),
            damping_schedule=ConstantSchedule(1e-3), **opt_kwargs),
        _Batches(3, steps, torch.tensor), smpl_t, range(3), TrainState(state_t, None, None),
        functools.partial(create_loss_fn, clip_mask_fn=median_log_squeeze_and_mask), []))
    assert len(got) == len(want) == 3
    for (step, _, mol_idxs, stats, samples), (_, _, mol_idxs_j, stats_j, samples_j) in zip(
            got, want):
        np.testing.assert_array_equal(mol_idxs, np.asarray(mol_idxs_j))
        assert stats['energy/ewm'].shape == (2, 1)
        assert_close(samples['local_energy/samples'], samples_j['local_energy/samples'],
                     REL_STEP, f'step {step}: E_loc')
        for key in ('energy/ewm', 'local_energy/mean', 'local_energy/std'):
            assert_close(stats[key], stats_j[key], REL_STEP, f'step {step}: {key}')
    paths = jax_param_paths(wf)
    final = want[-1][1].params
    for key, value in wf.state_dict().items():
        path, name = paths[key]
        assert_close(value, np.asarray(final[path][name])[0], REL_STEP, f'{path}/{name}')


class _FixedGrid:
    """A sampler of either package's interface that returns the same walkers."""

    def __init__(self, phys_conf):
        self.phys_conf = phys_conf

    def sample(self, *args):
        return args[1], self.phys_conf, {}


@pytest.mark.parametrize('opt_name', ['adam', 'lamb'])
def test_pretraining_step_on_a_molecule_batch_matches_jax(opt_name, tmp_path):
    """One pretraining step (``pretrain``) on both geometries at once, each
    held to its own SCF orbitals (one SCF per geometry, the port's, given to
    both packages): the per-walker losses ``[2, 1, B]`` and every updated
    parameter within 1e-10 of JAX's."""
    import optax

    from deepqmc_tpu.pretrain import pretrain as jax_pretrain
    from deepqmc_tpu.utils import tree_unstack
    from deepqmc_tpu_torch.optimizer import adam, lamb
    from deepqmc_tpu_torch.pretrain import compute_scf_solution, pretrain

    hamil_j, ansatz, params, R, r, _, _ = _setup(1)
    hamil_t, wf = _port_wf(params)
    mols = _geometries(dqt, hamil_t, 2)
    dataset = compute_scf_solution(mols, hamil_t, 1, basis='sto-6g', workdir=str(tmp_path))
    kwargs = dict(learning_rate=3e-4, b1=0.9, b2=0.999)
    pc_j = JaxConf(jnp.asarray(np.broadcast_to(R[:, None, None], (2, 1, B, *R.shape[1:]))),
                   jnp.asarray(r), jnp.broadcast_to(jnp.arange(2)[:, None, None], (2, 1, B)))
    ds_j = {k: v if k == 'shells' else jnp.asarray(np.asarray(v)) for k, v in dataset.items()}
    ((_, want_params, want_losses, _),) = list(jax_pretrain(
        jax.random.PRNGKey(0), hamil_j, ansatz, tree_stack(params),
        getattr(optax, opt_name)(**kwargs), _Batches(2, [[0, 1]], jnp.asarray), _FixedGrid(pc_j),
        {}, ds_j, steps=range(1)))
    (want_params,) = tree_unstack(want_params)
    pc_t = _port_batch(R, r, np.ones(r.shape[:3]), (np.zeros(1), np.zeros(1)))[0]
    smpl_state = {'elec': {'r': pc_t.r}}
    ((_, losses, mol_idxs),) = list(pretrain(
        None, hamil_t, wf, {'adam': adam, 'lamb': lamb}[opt_name](**kwargs),
        _Batches(2, [[0, 1]], torch.tensor), _FixedGrid(pc_t), smpl_state, dataset,
        steps=range(1)))
    assert tuple(losses.shape) == (2, 1, B) and mol_idxs.tolist() == [0, 1]
    assert_close(losses, want_losses, REL, 'per-walker losses')
    paths = jax_param_paths(wf)
    for key, value in wf.state_dict().items():
        path, name = paths[key]
        assert_close(value, want_params[path][name], REL, f'{path}/{name}')
