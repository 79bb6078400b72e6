"""The port's optimizers and training loop: three Adam steps against the JAX
package's ``OptaxOptimizer`` with ``optax.adam`` and the sampler's psi refresh
against JAX ``MetropolisSampler.update`` under the new parameters (float64,
the small PsiFormer, the same walkers); the launches of one training step
through the kernels' wrappers on the CPU; and ``train`` on H2, which must lower
the energy as the JAX package's ``test_kfac_trains_h2`` requires."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import (
    SMALL,
    assert_close,
    jax_batch,
    jax_model,
    torch_model,
    torch_phys_conf,
    walkers,
)

import deepqmc_tpu_torch as dqt
from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import median_log_squeeze_and_mask as jax_clip
from deepqmc_tpu.optimizer import OptaxOptimizer
from deepqmc_tpu.sampling.electron_samplers import MetropolisSampler as JaxMetropolis
from deepqmc_tpu.utils import tree_stack, tree_unstack
from deepqmc_tpu_torch.fit import molecule_state
from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
from deepqmc_tpu_torch.nn import jax_param_paths
from deepqmc_tpu_torch.optimizer import AdamOptimizer
from deepqmc_tpu_torch.sampling import MetropolisSampler

REL, REL_STEP = 1e-10, 1e-9


def test_adam_steps_and_psi_refresh_match_jax():
    """Three Adam steps (lr 1e-3, bench.py's setting) on LiH, each on its own
    walkers, then the psi of the walkers refreshed under the new parameters."""
    hamil_j, ansatz, params = jax_model('LiH')
    hamil_t, wf = torch_model('LiH', params)
    rs = [walkers(hamil_j, 'init_sample', n=8, seed=10 * k) for k in range(3)]
    opt_j = OptaxOptimizer(jax_create_loss_fn(hamil_j, ansatz, jax_clip).value_and_grad,
                           optax_opt=optax.adam(1e-3))
    opt_t = AdamOptimizer(create_loss_fn(hamil_t, wf, median_log_squeeze_and_mask), lr=1e-3)
    rng = jax.random.PRNGKey(0)
    stacked = tree_stack([params])
    state_j = opt_j.init(rng, stacked, jax_batch(hamil_j, rs[0]))
    state_t = opt_t.init(torch_phys_conf(hamil_t, rs[0]))
    step_j = jax.jit(opt_j.step)
    paths = jax_param_paths(wf)
    for step, r in enumerate(rs):
        stacked, state_j, E_j, _, stats_j = step_j(rng, stacked, state_j, jax_batch(hamil_j, r))
        state_t, E_t, _, stats_t = opt_t.step(state_t, torch_phys_conf(hamil_t, r),
                                              torch.ones(len(r), dtype=torch.float64))
        (want,) = tree_unstack(stacked)
        for key, value in wf.state_dict().items():
            path, name = paths[key]
            assert_close(value, want[path][name], REL_STEP, f'step {step}: {path}/{name}')
        assert_close(E_t, np.asarray(E_j)[0, 0], REL, 'E_loc')
        for k in ('opt/param_norm', 'opt/grad_norm', 'opt/update_norm'):
            assert_close(stats_t[k], stats_j[k], REL_STEP, k)
        assert state_t['count'] == step + 1

    r = rs[-1]
    sampler_j = JaxMetropolis(hamil_j, ansatz.apply, tau=0.3)
    R_j = jnp.asarray(hamil_j.mol.coords)
    base = {'r': jnp.asarray(r), 'age': jnp.zeros(len(r), jnp.int32), 'tau': jnp.asarray(0.3)}
    want = sampler_j.update(base, tree_unstack(stacked)[0], R_j)['psi']
    stale = sampler_j.update(base, params, R_j)['psi']
    R_t = torch.as_tensor(hamil_t.mol.coords)
    with torch.no_grad():
        got = MetropolisSampler(hamil_t, wf, tau=0.3).update(
            {'r': torch.tensor(r), 'age': torch.zeros(len(r), dtype=torch.long),
             'tau': torch.tensor(0.3, dtype=torch.float64)}, R_t)['psi']
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    assert_close(got.log, want.log, REL, 'refreshed log psi')
    assert np.abs(np.asarray(want.log) - np.asarray(stale.log)).max() > 1e-6  # psi moved


def test_training_step_launches_through_the_kernel_wrappers(monkeypatch):
    """A float32 KFAC step on the CPU through wrappers that run each kernel's
    input checks before its plain version: one step calls the attention core 4
    times and the flat log-determinant traces once, both from the local
    energy (the gradient, curvature and refresh forwards call neither)."""
    from deepqmc_tpu_torch.ops import fl_attention, fl_block, fl_slogdet

    seen = []

    def attention(*args):
        fl_attention.validate(*args)
        seen.append('fl_attention')
        return fl_attention.mha_core_fl_plain(*args)

    def traces(*args):
        fl_slogdet.validate(*args)
        seen.append('fl_slogdet')
        return fl_slogdet.slogdet_traces_plain(*args)

    def block(*args, **kwargs):
        raise AssertionError('the per-op path called the block kernel')

    monkeypatch.setattr(fl_attention, 'mha_core_fl', attention)
    monkeypatch.setattr(fl_slogdet, 'slogdet_traces', traces)
    monkeypatch.setattr(fl_block, 'psiformer_block_fl', block)
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2O'))
    wf = dqt.psiformer_ansatz(hamil, n_determinants=2, embedding_dim=32, n_interactions=4,
                              num_heads=2)
    for _, state, E_loc, stats in dqt.fit.train(hamil, wf, n_walkers=8, steps=2, decorr=2,
                                            device='cpu'):
        assert seen == ['fl_attention'] * 4 + ['fl_slogdet']
        seen.clear()
        assert E_loc.shape == (8,) and torch.isfinite(E_loc).all()
        assert torch.isfinite(stats['opt/update_norm'])


def test_train_lowers_the_energy_of_h2():
    """40 KFAC steps (bench.py's settings) of 128 walkers on H2 with the small
    PsiFormer, float32 on the CPU: finite throughout, and the criterion of the
    JAX package's ``test_kfac_trains_h2``.  The sampler's cached psi is the
    wave function's under the final parameters (the refresh ran)."""
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    wf = dqt.psiformer_ansatz(hamil, **SMALL)
    energies, before = [], None
    for step, train_state, E_loc, stats in dqt.fit.train(hamil, wf, n_walkers=128, steps=40,
                                                     decorr=3, device='cpu'):
        params = torch.cat([p.detach().flatten() for p in wf.parameters()])
        assert before is None or not torch.equal(params, before), f'step {step}'
        before = params.clone()
        assert torch.isfinite(E_loc).all() and E_loc.shape == (128,)
        assert all(torch.isfinite(v).all() for v in stats.values())
        energies.append(stats['local_energy/mean'].item())
    energies = np.array(energies)
    assert energies[-10:].mean() < energies[:5].mean() - 0.03
    assert -1.5 < energies[-10:].mean() < -0.7
    R, smpl = molecule_state(train_state.sampler)
    with torch.no_grad():
        fresh = wf(MetropolisSampler.phys_conf(R, smpl['r']))
    assert torch.equal(smpl['psi'].log, fresh.log)
    assert train_state.opt['step'] == 40


@pytest.mark.parametrize('optimizer', ['kfac', 'adam', 'none'])
def test_train_needs_cuda_unless_told(optimizer):
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is valid here')
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    wf = dqt.psiformer_ansatz(hamil, n_determinants=1, embedding_dim=8, n_interactions=1,
                              num_heads=2)
    with pytest.raises(RuntimeError, match='CUDA'):
        next(dqt.fit.train(hamil, wf, n_walkers=4, steps=1, optimizer=optimizer))
