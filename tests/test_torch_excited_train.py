"""Several electronic states through the port's sampler, run and monitors:
``MultiElectronicStateSampler`` of two LiH states (each under its own
parameters) against the JAX package's at float64 under the same numpy draws;
the excited states' monitors (``SpinMonitor``, ``PsiRatioMonitor``,
``OscillatorStrengthMonitor``) on one fixed batch against JAX's; and a
two-state ``train.train`` on the CPU (float32, ``train_excited_psiformer.yaml``
cut down: CASCI pretraining targets, the overlap and spin penalties, KFAC,
``merge_keys``, the spin monitor every step, the HDF5 whitelist of the
task) whose last checkpoint reloads bit for bit, then an evaluation from it
with the three monitors as ``conf/task/evaluate_excited.yaml``."""

import os
from functools import partial

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
    jax_model,
    jax_phys_conf,
    torch_model,
    walkers,
)

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt
from deepqmc_tpu import observable as jax_observable
from deepqmc_tpu.sampling import electron_samplers as jax_samplers
from deepqmc_tpu.sampling import sampling_utils as jax_sampling_utils
from deepqmc_tpu.types import Psi as JaxPsi
from deepqmc_tpu.utils import tree_stack
from deepqmc_tpu_torch import observable
from deepqmc_tpu_torch.fit import TrainState
from deepqmc_tpu_torch.log import CheckpointStore, H5Logger
from deepqmc_tpu_torch.loss import create_loss_fn, median_clip_and_mask, psi_ratio_clip_and_mask
from deepqmc_tpu_torch.optimizer import KFACOptimizer
from deepqmc_tpu_torch.sampling import (
    DecorrSampler,
    MetropolisSampler,
    RECIPES,
    chain,
    initialize_sampling,
)
from deepqmc_tpu_torch.train import train
from deepqmc_tpu_torch.types import PhysicalConfiguration, Psi
from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule
from deepqmc_tpu_torch.wf import StateStack
from deepqmc_tpu_torch.wf.base import merged_keys

REL, B = 1e-12, 16


def _two_states():
    hamil_j, ansatz, params = jax_model('LiH', seed=0)
    params = [params, jax_model('LiH', seed=1)[2]]
    mods = [torch_model('LiH', p) for p in params]
    return hamil_j, ansatz, params, mods[0][0], StateStack([wf for _, wf in mods])


def test_multi_electronic_state_sampler_matches_jax(monkeypatch):
    """Two states' walkers refreshed under their own parameters, then one
    sample call (2 Metropolis moves each) with the same draws: walkers, psi,
    ages, step sizes, the configuration's layout and the per-state stats."""
    hamil_j, ansatz, params, hamil_t, stack = _two_states()
    _, smp_j = jax_sampling_utils.initialize_sampling(
        jax.random.PRNGKey(0), hamil_j, ansatz, [hamil_j.mol], 2, 1,
        elec_sampler=lambda hamil, wf: jax_sampling_utils.chain(
            jax_samplers.DecorrSampler(length=2),
            jax_samplers.MetropolisSampler(hamil, wf, tau=0.3)))
    _, smp_t = initialize_sampling(
        torch.Generator().manual_seed(0), hamil_t, stack, [hamil_t.mol], 2, 1,
        elec_sampler=lambda hamil, wf: chain(DecorrSampler(length=2),
                                             MetropolisSampler(hamil, wf, tau=0.3)))
    assert all(s.wf is wf for s, wf in zip(smp_t.elec.samplers, stack, strict=True))
    rs = np.stack([walkers(hamil_j, 'init_sample', n=B, seed=s) for s in range(2)])[None]
    R = np.asarray(hamil_j.mol.coords)[None]
    params_j = tree_stack(params)
    st_j = jax.jit(smp_j.update)({
        'nuc': {'R': jnp.asarray(R)},
        'elec': {'r': jnp.asarray(rs), 'age': jnp.zeros(rs.shape[:3], jnp.int32),
                 'tau': jnp.full((1, 2), 0.3)},
        'update_nuc_counter': jnp.zeros(1),
    }, params_j)
    with torch.no_grad():
        st_t = smp_t.update({
            'nuc': {'R': torch.tensor(R)},
            'elec': {'r': torch.tensor(rs), 'age': torch.zeros(rs.shape[:3], dtype=torch.long),
                     'tau': torch.full((1, 2), 0.3, dtype=torch.float64)},
            'update_nuc_counter': torch.zeros(1, dtype=torch.long),
        })
    assert_close(st_t['elec']['psi'].log, st_j['elec']['psi'].log, REL, 'psi of both states')
    rng = np.random.default_rng(0)
    feed_draws(monkeypatch, [rng.normal(size=rs.shape[2:])], [rng.uniform(size=B)])
    want, pc_j, stats_j = jax.jit(smp_j.sample)(jax.random.PRNGKey(1), st_j, params_j,
                                                jnp.array([0]))
    with torch.no_grad():
        got, pc_t, stats_t = smp_t.sample(None, st_t, torch.tensor([0]))
    assert pc_t.r.shape == (1, 2, B, 4, 3) and pc_t.mol_idx.shape == (1, 2, B)
    assert_close(pc_t.r, pc_j.r, REL, 'walkers')
    for s in range(2):
        got_s = {k: v[0, s] for k, v in got['elec'].items() if k != 'psi'}
        want_s = {k: v[0, s] for k, v in want['elec'].items() if k != 'psi'}
        got_s['psi'] = Psi(*(x[0, s] for x in got['elec']['psi']))
        want_s['psi'] = JaxPsi(*(x[0, s] for x in want['elec']['psi']))
        assert_sampler_states(got_s, want_s, ('r', 'psi', 'tau'))
    assert_stats(stats_t, stats_j)
    assert not torch.equal(pc_t.r[0, 0], pc_t.r[0, 1])


def _fixed_batch():
    """(JAX monitor arguments, port monitor arguments) of one two-state LiH
    batch: walkers, seeded local energies of two levels and seeded ratios."""
    hamil_j, ansatz, params, hamil_t, stack = _two_states()
    rs = np.stack([walkers(hamil_j, 'init_sample', n=B, seed=5 + s) for s in range(2)])[None]
    rng = np.random.default_rng(1)
    E = np.array([-8.0, -7.7])[None, :, None] + 0.05 * rng.normal(size=(1, 2, B))
    ratios = 0.2 + rng.normal(size=(1, 2, 2, B))
    pcs = [jax_phys_conf(hamil_j, r) for r in rs[0]]
    pc_j = jax.tree_util.tree_map(lambda *x: jnp.stack(x)[None], *pcs)
    psi = (np.ones((1, 2, B)), np.zeros((1, 2, B)))
    jax_args = (tree_stack(params), pc_j, JaxPsi(*map(jnp.asarray, psi)), jnp.asarray(E),
                jnp.asarray(ratios))
    pc_t = PhysicalConfiguration(torch.as_tensor(hamil_t.mol.coords)[None], torch.tensor(rs),
                                 torch.zeros(1, 2, B, dtype=torch.long))
    port_args = (stack.state_dict(), pc_t, Psi(*map(torch.tensor, psi)), torch.tensor(E),
                 torch.tensor(ratios))
    return (hamil_j, ansatz, jax_args), (hamil_t, stack, port_args)


@pytest.mark.parametrize('name', ['SpinMonitor', 'PsiRatioMonitor', 'OscillatorStrengthMonitor'])
def test_excited_monitors_match_jax_on_a_fixed_batch(name):
    """Each monitor's stats (and samples) as JAX's.  The oscillator strengths
    follow ``observable.py``'s algebra, whose zero-gap diagonal has zero error
    (the postprocess ``oscillator_strength.py`` gives NaN there and a 1.5 times
    larger error: a reference-side hazard, ROADMAP.md queue 3)."""
    (hamil_j, ansatz, args_j), (hamil_t, stack, args_t) = _fixed_batch()
    want = getattr(jax_observable, name)(save_samples=True, period=1).finalize(
        hamil_j, ansatz.apply)(0, *args_j)
    got = getattr(observable, name)(save_samples=True, period=1).finalize(
        hamil_t, stack)(0, *args_t)
    assert set(got) == set(want)
    for k, v in want.items():
        assert_close(got[k], v, 1e-10, k)
    if name == 'OscillatorStrengthMonitor':
        for k in ('oscillator_strength/mean', 'oscillator_strength/err'):
            assert torch.equal(torch.diagonal(got[k], dim1=-2, dim2=-1), torch.zeros(1, 2,
                                                                                    dtype=got[k].dtype))
            assert torch.isfinite(got[k]).all()
    if name == 'SpinMonitor':
        assert got['spin/mean'].shape == (1, 2)


def test_monitors_need_several_states():
    with pytest.raises(ValueError, match='more than one electronic state'):
        observable.oscillator_strength_statistics(observable.Batch(
            None, None, None, torch.zeros(1, 1, 3), None), None)


MERGE = ['exponential_envelopes']
TINY = dict(n_determinants=2, embedding_dim=16, n_interactions=1, num_heads=2)


def test_two_state_run_checkpoint_and_evaluation(tmp_path):
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('LiH'))
    loss = partial(create_loss_fn, clip_mask_fn=partial(median_clip_and_mask, clip_width=5,
                                                        median_center=True),
                   alpha=4.0, scale_overlap_by='max_gap_std', min_gap_scale_factor=1e-3,
                   clip_mask_overlap_fn=psi_ratio_clip_and_mask, spin_penalty=0.1)
    opt = partial(KFACOptimizer, learning_rate_schedule=InverseSchedule(0.05, 50000),
                  damping_schedule=ConstantSchedule(1e-3), norm_constraint=1e-3,
                  inverse_update_period=5)
    factory = partial(initialize_sampling, elec_sampler=RECIPES['decorr_metropolis_psiformer'])
    h5 = partial(H5Logger, keys_whitelist=['spin', 'overlap/pairwise', 'time'])
    state = train(hamil, partial(dqt.psiformer_ansatz, hamil, **TINY), opt, factory, steps=3,
                  seed=0, electron_batch_size=B, electronic_states=2, workdir=str(tmp_path),
                  max_eq_steps=2, pretrain_steps=2,
                  pretrain_kwargs={'opt': 'lamb', 'scf_kwargs': {'basis': 'sto-6g',
                                                                 'cas': (2, 2)}},
                  loss_function_factory=loss, merge_keys=MERGE, h5_logger_constructor=h5,
                  chkpt_constructor=partial(CheckpointStore, interval=1),
                  observable_monitors=[observable.SpinMonitor(save_samples=False, period=1)],
                  device='cpu')
    assert state.opt['step'] == 3 and len(state.opt['factors']) == 2
    assert state.sampler['elec']['r'].shape == (1, 2, B, 4, 3)
    stack = StateStack([dqt.psiformer_ansatz(hamil, **TINY) for _ in range(2)])
    stack.load_state_dict(state.params)
    keys = merged_keys(stack, MERGE)
    assert keys and all(torch.equal(stack[0].state_dict()[k], stack[1].state_dict()[k])
                        for k in keys)
    assert not torch.equal(stack[0].state_dict()['omni.gnn.electron_embedding.linear.w'],
                           stack[1].state_dict()['omni.gnn.electron_embedding.linear.w'])

    path = tmp_path / 'training' / 'chkpt-3.pt'
    step, loaded = CheckpointStore.load(path)
    assert step == 3
    assert all(torch.equal(loaded.params[k], v) for k, v in state.params.items())
    assert torch.equal(loaded.sampler['elec']['r'], state.sampler['elec']['r'])
    for key in ('factors', 'inverses'):
        for got_s, want_s in zip(loaded.opt[key], state.opt[key]):
            assert all(torch.equal(a, b) for p in want_s for a, b in zip(got_s[p], want_s[p]))
    import h5py

    with h5py.File(tmp_path / 'training' / 'result.h5', 'r') as f:
        assert f['spin/mean'].shape == (3, 1, 2) and f['overlap/pairwise/mean'].shape == (3, 1, 2, 2)
        assert 'time' in f and np.isfinite(f['spin/mean'][...]).all()

    monitors = [observable.OscillatorStrengthMonitor(save_samples=False, period=1),
                observable.SpinMonitor(save_samples=False, period=1),
                observable.PsiRatioMonitor(save_samples=True, period=1)]
    before = {k: v.clone() for k, v in stack.state_dict().items()}
    seen = []

    class Results:
        def __init__(self, workdir, keys, *, init_step=0, aux_data=None):
            pass

        def update(self, data):
            seen.append(data)

        def close(self):
            pass

    evaluated = train(hamil, stack, None, factory, steps=2, seed=0, electron_batch_size=B,
                      electronic_states=2, workdir=str(tmp_path),
                      train_state=TrainState(loaded.sampler, loaded.params, None),
                      loss_function_factory=loss, observable_monitors=monitors,
                      h5_logger_constructor=Results, device='cpu')
    assert all(torch.equal(v, before[k]) for k, v in stack.state_dict().items())
    assert evaluated.opt is None and len(seen) == 2
    for data in seen:
        f = data['oscillator_strength/mean']
        assert f.shape == (1, 2, 2) and np.isfinite(f).all() and (np.diagonal(f, 0, 1, 2) == 0).all()
        assert data['spin/mean'].shape == (1, 2) and np.isfinite(data['spin/mean']).all()
        assert data['psi_ratio/samples'].shape == (1, 2, 2, B)
        assert data['overlap/pairwise/mean'].shape == (1, 2, 2)
    assert os.path.exists(tmp_path / 'evaluation')
