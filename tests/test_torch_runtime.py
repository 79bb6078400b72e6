"""The port's training run, ``deepqmc_tpu_torch.train.train``, on H2 on the
CPU (float32, a PsiFormer of one layer, 32 walkers): SCF pretraining with
LAMB, equilibration and the fit loop with the default monitors, its files in
``workdir/training``, and the HDF5 datasets and TensorBoard tags the JAX
package's ``train`` writes for the same settings; a NaN in the sampled psi
rewinds to the last checkpoint, NaNs at every step end in ``TrainingCrash``,
and an evaluation from a checkpoint leaves the parameters alone."""

import logging
import os
from functools import partial

import h5py
import numpy as np
import pytest
import tensorboardX
import torch
import torch_parity  # noqa: F401  (one intra-op thread per pytest worker)

import deepqmc_tpu_torch as dqt
from deepqmc_tpu_torch import fit
from deepqmc_tpu_torch.exceptions import TrainingCrash
from deepqmc_tpu_torch.log import CheckpointStore
from deepqmc_tpu_torch.optimizer import AdamOptimizer, KFACOptimizer
from deepqmc_tpu_torch.sampling import RECIPES, initialize_sampling
from deepqmc_tpu_torch.train import train
from deepqmc_tpu_torch.types import Psi

TINY = dict(n_determinants=2, embedding_dim=16, n_interactions=1, num_heads=2)
SETTINGS = dict(steps=6, seed=0, electron_batch_size=32, max_eq_steps=5, pretrain_steps=3,
                pretrain_kwargs={'opt': 'lamb', 'opt_kwargs': {'learning_rate': 3e-4},
                                 'scf_kwargs': {'basis': 'sto-6g'}})


def _h2():
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    return hamil, dqt.psiformer_ansatz(hamil, **TINY)


def _sampler_factory():
    return partial(initialize_sampling, elec_sampler=RECIPES['decorr_metropolis'])


def _recording_tags(monkeypatch):
    tags = set()
    add_scalar = tensorboardX.SummaryWriter.add_scalar

    def record(self, tag, *args, **kwargs):
        tags.add(tag)
        return add_scalar(self, tag, *args, **kwargs)

    monkeypatch.setattr(tensorboardX.SummaryWriter, 'add_scalar', record)
    return tags


def _h5_keys(path):
    keys = []
    with h5py.File(path, 'r') as f:
        f.visititems(lambda name, obj: keys.append(name) if isinstance(obj, h5py.Dataset)
                     else None)
        return sorted(keys), {k: f[k][...] for k in keys}


def _jax_run(tmp_path, monkeypatch):
    """(HDF5 datasets, TensorBoard tags) of the JAX package's train with the
    same settings: Adam (optax) and the decorr_metropolis recipe."""
    import optax

    import deepqmc_tpu as dqj
    from deepqmc_tpu.optimizer import OptaxOptimizer
    from deepqmc_tpu.presets import ansatz_preset
    from deepqmc_tpu.sampling import (
        DecorrSampler,
        MetropolisSampler,
        combine_samplers,
    )
    from deepqmc_tpu.sampling import initialize_sampling as jax_initialize_sampling
    from deepqmc_tpu.train import train as jax_train
    from deepqmc_tpu.wf import instantiate_ansatz

    tags = _recording_tags(monkeypatch)
    hamil = dqj.MolecularHamiltonian(mol=dqj.Molecule.from_name('H2'))
    ansatz = instantiate_ansatz(hamil, ansatz_preset('psiformer', **TINY))
    sampler_factory = partial(jax_initialize_sampling, elec_sampler=partial(
        combine_samplers, [DecorrSampler(length=20), partial(MetropolisSampler, tau=1.0,
                                                             max_age=20)]))
    jax_train(hamil, ansatz, partial(OptaxOptimizer, optax_opt=optax.adam(1e-3)),
              sampler_factory, workdir=str(tmp_path), **SETTINGS)
    return _h5_keys(tmp_path / 'training' / 'result.h5')[0], tags


def test_train_runs_and_writes_what_jax_writes(tmp_path, monkeypatch):
    """Pretraining (3 LAMB steps on the 'sto-6g' SCF baseline), equilibration
    (at most 5 calls) and 6 Adam steps with a checkpoint every 2: the
    parameters change, the checkpoints of steps 0, 2, 4 and 6 and the SCF
    solution are written, ``result.h5`` holds 6 finite rows of each dataset,
    and the datasets and TensorBoard tags are JAX's, save
    ``hamil/V_nl/0/0``, the pseudopotential term the port's all-electron
    Hamiltonian does not have."""
    want_keys, want_tags = _jax_run(tmp_path / 'jax', monkeypatch)
    monkeypatch.undo()
    tags = _recording_tags(monkeypatch)
    hamil, wf = _h2()
    before = {k: v.clone() for k, v in wf.state_dict().items()}
    state = train(hamil, wf, partial(AdamOptimizer, lr=1e-3), _sampler_factory(),
                  workdir=str(tmp_path / 'port'), device='cpu',
                  chkpt_constructor=partial(CheckpointStore, interval=2), **SETTINGS)
    assert isinstance(state, fit.TrainState) and state.opt['count'] == 6
    assert all(not torch.equal(v, before[k]) for k, v in wf.state_dict().items()
               if not k.startswith('cusp_electrons.'))
    run_dir = tmp_path / 'port' / 'training'
    files = os.listdir(run_dir)
    assert {f'chkpt-{i}.pt' for i in (0, 2, 4, 6)} == {f for f in files if f.startswith('chkpt')}
    assert any('tfevents' in f for f in files)
    assert (run_dir / 'scf_chkpts' / 'mol_0.npz').exists()
    keys, data = _h5_keys(run_dir / 'result.h5')
    assert keys == want_keys
    for key, value in data.items():
        assert len(value) == 6 and np.isfinite(value).all(), key
    assert data['psi/samples/log'].shape == (6, 1, 1, 32)
    assert tags == want_tags - {'hamil/V_nl/0/0'}


def _nan_at(calls, monkeypatch):
    """Make ``fit.train_step`` return a NaN psi at the given (0-based) calls,
    or at every call with ``calls`` None; record the parameters the module
    holds when each call starts and when it ends."""
    step, seen = fit.train_step, []

    def train_step(*args):
        params = args[3].params  # the module's state_dict: it follows the module
        start = {k: v.clone() for k, v in params.items()}
        out = step(*args)
        seen.append((start, {k: v.clone() for k, v in params.items()}))
        if calls is None or len(seen) - 1 in calls:
            state = out[0].sampler
            psi = state['elec']['psi']
            state['elec']['psi'] = Psi(psi.sign, torch.full_like(psi.log, float('nan')))
        return out

    monkeypatch.setattr(fit, 'train_step', train_step)
    return seen


def test_nan_rewinds_to_the_last_checkpoint(tmp_path, monkeypatch, caplog):
    """A NaN at the third step (step 2), after its update of the parameters:
    the run logs the restart, loads the checkpoint of step 2 into the module
    and runs steps 2-5 again from it."""
    seen = _nan_at({2}, monkeypatch)
    hamil, wf = _h2()
    with caplog.at_level(logging.WARNING, logger='deepqmc_tpu_torch.train'):
        state = train(hamil, wf, partial(KFACOptimizer, **fit.DEFAULT_OPT_KWARGS['kfac']),
                      _sampler_factory(), steps=6, seed=0,
                      electron_batch_size=32, max_eq_steps=3, workdir=str(tmp_path),
                      device='cpu', chkpt_constructor=partial(CheckpointStore, interval=2))
    assert 'Restarting due to NanError...' in caplog.messages
    assert len(seen) == 7  # steps 0, 1, 2 (NaN), then 2, 3, 4, 5
    _, chkpt = CheckpointStore.load(tmp_path / 'training' / 'chkpt-2.pt')
    (_, nan_step_end), (rerun_start, _) = seen[2], seen[3]
    assert all(torch.equal(rerun_start[k], v) for k, v in chkpt.params.items())
    assert not all(torch.equal(nan_step_end[k], v) for k, v in rerun_start.items())
    assert state.opt['step'] == 6
    _, data = _h5_keys(tmp_path / 'training' / 'result.h5')
    assert len(data['local_energy/mean']) == 6  # the NaN step is not recorded


@pytest.mark.parametrize('with_workdir', [True, False])
def test_nan_at_every_step_crashes(with_workdir, tmp_path, monkeypatch, caplog):
    """Three attempts (``max_restarts``), then ``TrainingCrash`` with the
    train state; each attempt starts from the parameters the fit began with
    (the first checkpoint's, or without a workdir a copy of them), though the
    failed step changed them."""
    seen = _nan_at(None, monkeypatch)
    hamil, wf = _h2()
    with caplog.at_level(logging.WARNING, logger='deepqmc_tpu_torch.train'):
        with pytest.raises(TrainingCrash) as crash:
            train(hamil, wf, partial(AdamOptimizer), _sampler_factory(), steps=4, seed=0,
                  electron_batch_size=16, max_eq_steps=2, device='cpu',
                  workdir=str(tmp_path) if with_workdir else None)
    assert caplog.messages.count('Restarting due to NanError...') == 3
    assert 'crashed before all steps were completed (0/4)' in caplog.messages[-1]
    assert isinstance(crash.value.train_state, fit.TrainState)
    assert len(seen) == 3
    (first, changed), *rest = seen
    assert not all(torch.equal(changed[k], v) for k, v in first.items())
    for start, _ in rest:
        assert all(torch.equal(start[k], v) for k, v in first.items())


def test_evaluation_from_a_checkpoint_leaves_the_parameters(tmp_path):
    """Train 2 steps, then evaluate 3 steps from the last checkpoint with
    ``opt=None`` and the checkpoint's walkers: finite energies in
    ``workdir/evaluation``, no equilibration, no checkpoint, parameters bit-equal."""
    hamil, wf = _h2()
    train(hamil, wf, partial(AdamOptimizer), _sampler_factory(), steps=2, seed=0,
          electron_batch_size=16, max_eq_steps=2, workdir=str(tmp_path), device='cpu')
    step, chkpt = CheckpointStore.load(tmp_path / 'training' / 'chkpt-2.pt')
    assert step == 2
    _, wf_eval = _h2()
    state = train(hamil, wf_eval, None, _sampler_factory(), steps=3, seed=1,
                  electron_batch_size=16, max_eq_steps=0, workdir=str(tmp_path), device='cpu',
                  train_state=fit.TrainState(chkpt.sampler, chkpt.params, None))
    assert all(torch.equal(v, chkpt.params[k]) for k, v in wf_eval.state_dict().items())
    assert state.opt is None
    files = os.listdir(tmp_path / 'evaluation')
    assert 'result.h5' in files and not any(f.startswith('chkpt') for f in files)
    _, data = _h5_keys(tmp_path / 'evaluation' / 'result.h5')
    assert len(data['local_energy/samples']) == 3
    assert np.isfinite(data['local_energy/samples']).all()


def test_blocks_run_extra_monitors_on_their_last_step(tmp_path):
    """``fit_block_size=2`` with a monitor of its own (the walkers' mean
    electron-nucleus distance, every step): its stats and samples come on the
    last step of each block only, with the energy statistics on every step,
    and the block's time split over its steps."""
    from deepqmc_tpu_torch.observable import MonitorSpec, ObservableMonitor

    class DistanceMonitor(ObservableMonitor):
        name = 'dist'

        def spec(self, hamil, wf):
            def sample(batch):
                r, R = batch.phys_conf.r, batch.phys_conf.R
                return (r[..., :, None, :] - R[:, None, None, None]).norm(dim=-1).mean((-2, -1))

            return MonitorSpec('dist', sample, lambda b, x: {'dist/mean': x.mean(-1)})

    seen = []

    class Recording:
        def __init__(self, workdir, n_mol):
            pass

        def update(self, step, stats, multi_stats, mol_idxs, prefix=None):
            if prefix is None:
                seen.append((step, stats))

        def close(self):
            pass

    hamil, wf = _h2()
    train(hamil, wf, partial(AdamOptimizer), _sampler_factory(), steps=4, seed=0,
          electron_batch_size=16, max_eq_steps=2, workdir=str(tmp_path), device='cpu',
          fit_block_size=2, metric_logger_constructor=Recording,
          observable_monitors=[DistanceMonitor(save_samples=True, period=1)])
    assert [step for step, _ in seen] == [0, 1, 2, 3]
    for step, stats in seen:
        assert ('dist/mean' in stats) == (step % 2 == 1), step
        assert np.isfinite(stats['local_energy/mean']).all()
    assert seen[0][1]['perf/step_time'] == seen[1][1]['perf/step_time']
    assert seen[1][1]['dist/mean'].shape == (1, 1) and seen[1][1]['dist/mean'] > 0
    _, data = _h5_keys(tmp_path / 'training' / 'result.h5')
    assert data['dist/samples'].shape == (2, 1, 1, 16)
