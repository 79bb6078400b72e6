"""The port's command line (``python -m deepqmc_tpu_torch``) on the CPU.

``tests/test_app.py``'s tiny H2 run (one step, 8 walkers, Adam-W, the small
``default`` ansatz) with the two sinks the card's machine may lack turned
off, then ``task=restart`` and ``task=evaluate`` from its checkpoints, each
a subprocess of the true entry point, with their step counts and files; the
sinks' failure without their packages; the options the port refuses; a
tiny ``ansatz=deeperwin`` run; the ansatz each of
``ansatz=default|ferminet|psiformer`` and overrides of the tree (an
envelope switch, explicit MLP widths) build at small width against the JAX
command line's network (parameter count and log|psi| at float64 with JAX's
parameters carried across by ``convert``); keys and values the JAX classes
refuse; the
optimizer and sampler trees; ``optimizer.adamw`` against ``optax.adamw``.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from torch_parity import init_sample, jax_phys_conf, jit_once, torch_phys_conf, walkers

from deepqmc_tpu import config as jax_config
from deepqmc_tpu.wf import instantiate_ansatz
from deepqmc_tpu_torch import app, config
from deepqmc_tpu_torch.convert import state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
TINY = ['hamil/mol=H2', 'task.steps=1', 'task.electron_batch_size=8', '+task.max_eq_steps=1',
        'task.pretrain_steps=null', 'task/opt=adamw', 'ansatz.n_determinants=2',
        'ansatz.omni_factory.embedding_dim=16', 'ansatz.omni_factory.gnn_factory.n_interactions=1']
NO_SINKS = ['task.metric_logger_constructor=null', 'task.h5_logger_constructor=null']


def _cli(*args, workdir):
    proc = subprocess.run(
        [sys.executable, '-m', 'deepqmc_tpu_torch', '--device=cpu', *args,
         f'--workdir={workdir}'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, 'OMP_NUM_THREADS': '1'},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (Path(workdir) / 'deepqmc.log').read_text()
    steps = [json.loads(m) for m in re.findall(r'(?:training|evaluation) step \d+: (\{.*\})',
                                                  log)]
    return log, steps


def test_cli_trains_restarts_and_evaluates(tmp_path):
    run, restart, evaluate = tmp_path / 'run', tmp_path / 'restart', tmp_path / 'evaluate'
    log, steps = _cli(*TINY, *NO_SINKS, workdir=run)
    for line in ('Equilibrating sampler...', 'Start training', 'The training has been completed!',
                 'Running on the CPU'):
        assert line in log
    assert len(steps) == 1 and all(n == 0 for n in steps[0]['launches'].values())
    want = config.compose(overrides=TINY + NO_SINKS)
    want['task']['workdir'] = str(run)
    assert json.loads((run / '.hydra' / 'config.json').read_text()) == want
    assert sorted(os.listdir(run / 'training')) == ['chkpt-0.pt', 'chkpt-1.pt']

    log, steps = _cli('task=restart', f'task.restdir={run}', '+task.steps=3', workdir=restart)
    assert 'Restart training from step 1' in log and 'The training has been completed!' in log
    assert len(steps) == 2
    assert sorted(os.listdir(restart / 'training')) == ['chkpt-2.pt', 'chkpt-3.pt']

    log, steps = _cli('task=evaluate', f'task.restdir={restart / "training"}', '+task.steps=2',
                      workdir=evaluate)
    assert 'Start evaluation' in log and 'The evaluation has been completed!' in log
    assert len(steps) == 2 and not (evaluate / 'evaluation' / 'chkpt-0.pt').exists()
    assert json.loads((evaluate / '.hydra' / 'config.json').read_text())['task']['restdir'] == \
        str(restart / 'training')


def test_cli_with_the_default_sinks(tmp_path):
    """Where tensorboardX and h5py are installed, the run of tests/test_app.py
    writes their files."""
    pytest.importorskip('tensorboardX')
    pytest.importorskip('h5py')
    _cli(*TINY, workdir=tmp_path)
    files = os.listdir(tmp_path / 'training')
    assert 'result.h5' in files and any('tfevents' in f for f in files)


@pytest.mark.parametrize('package, sink, key', [
    ('tensorboardX', 'TensorboardMetricLogger', 'metric_logger_constructor'),
    ('h5py', 'H5Logger', 'h5_logger_constructor'),
])
def test_sink_without_its_package_raises(monkeypatch, tmp_path, package, sink, key):
    from deepqmc_tpu_torch import log

    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(ImportError, match=rf'{package}.*task\.{key}=null'):
        getattr(log, sink)(str(tmp_path), 1)


def test_cli_needs_cuda_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is valid here')
    with pytest.raises(RuntimeError, match='CUDA'):
        app.cli([*TINY, f'--workdir={tmp_path}'])


@pytest.mark.parametrize('args, error, match', [
    # --slurm runs (tests/test_torch_slurm.py); an option sbatch lacks fails before submitting
    (['--slurm', *TINY, '+slurm.nodez=2'], ValueError, 'Unknown slurm options'),
    (['--platform=cpu', *TINY], ValueError, '--device'),
    (['--nonsense', *TINY], KeyError, 'Unknown config key: --nonsense'),
    (['task=evaluate_forces', 'task.restdir=/nowhere'], ValueError, 'not a directory'),
    # a molecule batch larger than the dataset (one that fits runs:
    # test_cli_trains_a_molecule_batch)
    ([*TINY, *NO_SINKS, 'task.molecule_batch_size=2'], ValueError,
     r'Molecule batch size \(2\) is larger than the number of molecules in the dataset \(1\)'),
    (['task=evaluate', 'task.restdir=/nowhere'], ValueError, 'not a directory'),
])
def test_cli_refuses(tmp_path, args, error, match):
    with pytest.raises(error, match=match):
        app.cli(['--device=cpu', *args, f'--workdir={tmp_path}'])


def test_cli_trains_a_molecule_batch(tmp_path):
    """Two H2 geometries of a molecule directory, both each step
    (``task.molecule_batch_size=2``), two pretraining steps on one SCF each,
    then two fit steps: finite walkers and energies."""
    mols = tmp_path / 'mols'
    mols.mkdir()
    for name, bond in (('h2_a', 0.70), ('h2_b', 0.80)):
        (mols / f'{name}.yaml').write_text(
            f'coords: [[0.0, 0.0, 0.0], [{bond}, 0.0, 0.0]]\ncharges: [1, 1]\ncharge: 0\n'
            'spin: 0\nunit: angstrom\n')
    train_state = app.cli(['--device=cpu', *TINY, *NO_SINKS, 'task.steps=2',
                           'task.pretrain_steps=2', 'task.molecule_batch_size=2',
                           f'task.mols.directory={mols}', f'--workdir={tmp_path / "run"}'])
    elec = train_state.sampler['elec']
    assert elec['r'].shape == (2, 1, 8, 2, 3) and torch.isfinite(elec['psi'].log).all()
    log = (tmp_path / 'run' / 'deepqmc.log').read_text()
    for line in ('Read 2 molecules', 'Pretraining completed', 'The training has been completed!'):
        assert line in log
    E = [json.loads(m)['E_mean'] for m in re.findall(r'training step \d+: (\{.*\})', log)]
    assert len(E) == 2 and np.isfinite(E).all()


SMALL = ['ansatz.n_determinants=2', 'ansatz.omni_factory.embedding_dim=16',
         'ansatz.omni_factory.gnn_factory.n_interactions=1']
TWO_PARTICLE = ['ansatz.omni_factory.gnn_factory.two_particle_stream_dim=8']


def test_cli_trains_deeperwin(tmp_path):
    """``ansatz=deeperwin`` at small width: the tiny run of one step."""
    app.cli(['--device=cpu', 'ansatz=deeperwin', *TINY, *TWO_PARTICLE, *NO_SINKS,
             f'--workdir={tmp_path}'])
    log = (tmp_path / 'deepqmc.log').read_text()
    assert 'The training has been completed!' in log
    assert len(re.findall(r'training step \d+: ', log)) == 1
    assert sorted(os.listdir(tmp_path / 'training')) == ['chkpt-0.pt', 'chkpt-1.pt']


@pytest.mark.parametrize('preset, extra', [
    ('default', TWO_PARTICLE), ('ferminet', TWO_PARTICLE + ['ansatz.full_determinant=false']),
    ('psiformer', []),
    ('ferminet', TWO_PARTICLE + ['ansatz.envelope.softplus_zeta=true']),
    ('ferminet', TWO_PARTICLE + [
        'ansatz.omni_factory.gnn_factory.layer_factory.subnet_factory.hidden_layers=[log, 3]']),
])
def test_cli_ansatz_matches_jax(preset, extra):
    overrides = [f'ansatz={preset}', 'hamil/mol=LiH', *SMALL, *extra]
    cfg_j = jax_config.compose(overrides=overrides, user_conf_dir=None)
    hamil_j = jax_config.instantiate(cfg_j['hamil'], root=cfg_j)
    ansatz = instantiate_ansatz(hamil_j, jax_config.instantiate(cfg_j['ansatz'], root=cfg_j))
    pc = init_sample(hamil_j, 1, 0)[0]
    params = jit_once(ansatz.init)(jax.random.PRNGKey(1), pc)
    noise = np.random.default_rng(0)
    params = {path: {k: np.asarray(v) + 0.1 * noise.normal(size=np.shape(v))
                     for k, v in bundle.items()} for path, bundle in params.items()}

    cfg_t = config.compose(overrides=overrides)
    hamil_t = config.instantiate(cfg_t['hamil'], root=cfg_t)
    wf = config.instantiate(cfg_t['ansatz'], root=cfg_t)(hamil_t).to(torch.float64)
    assert sum(p.numel() for p in wf.parameters()) == sum(
        np.size(v) for bundle in params.values() for v in bundle.values())
    wf.load_state_dict(state_dict_from_jax(params, wf))
    r = walkers(hamil_j, 'init_sample', n=3)
    want = jit_once(jax.vmap(ansatz.apply, (None, 0)))(params, jax_phys_conf(hamil_j, r))
    with torch.inference_mode():
        got = wf(torch_phys_conf(hamil_t, r))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.log.numpy(), np.asarray(want.log), rtol=1e-10)


@pytest.mark.parametrize('override, error, match', [
    pytest.param('ansatz.backflow_transform=exp', ValueError, 'backflow_transform',
                 id='ansatz.backflow_transform=exp'),
    pytest.param('+ansatz.foo=1', TypeError, 'foo', id='+ansatz.foo=1'),
])
def test_ansatz_override_the_port_cannot_build_raises(override, error, match):
    """A value the JAX class refuses, or a key it does not take, raises when
    the ansatz is built, naming the key (the JAX package takes any
    ``backflow_transform`` but 'mult' and 'add' for 'both' until its first
    call: ROADMAP.md, queue 3)."""
    cfg = config.compose(overrides=['ansatz=ferminet', 'hamil/mol=H2', override])
    hamil = config.instantiate(cfg['hamil'], root=cfg)
    factory = config.instantiate(cfg['ansatz'], root=cfg)
    with pytest.raises(error, match=match):
        factory(hamil)


def test_optimizer_and_sampler_trees_build():
    from deepqmc_tpu_torch.kfac import KFAC
    from deepqmc_tpu_torch.optimizer import KFACOptimizer, OptaxOptimizer
    from deepqmc_tpu_torch.sampling import initialize_sampling

    for name in ('kfac', 'kfac_psiformer', 'adamw'):
        cfg = config.compose(overrides=[f'task/opt={name}'])
        opt = config.instantiate(cfg['task']['opt'], root=cfg)
        assert opt.func is (OptaxOptimizer if name == 'adamw' else KFACOptimizer)
        if name != 'adamw':
            assert opt.keywords['kfac'].func is KFAC
            assert opt.keywords['kfac'].keywords['learning_rate_schedule'](10**5) == \
                pytest.approx(0.05 / (1 + 10**5 / {'kfac': 1e4, 'kfac_psiformer': 1e5}[name]))
    for name in ('decorr_langevin', 'decorr_metropolis', 'decorr_metropolis_ferminet',
                 'decorr_metropolis_psiformer'):
        cfg = config.compose(overrides=[f'task/sampler_factory={name}'])
        factory = config.instantiate(cfg['task']['sampler_factory'], root=cfg)
        assert factory.func is initialize_sampling
    with pytest.raises(NotImplementedError, match='estimation_mode'):
        KFAC(None, learning_rate_schedule=None, estimation_mode='ggn')


def test_adamw_matches_optax():
    from deepqmc_tpu_torch.optimizer import adamw

    rng = np.random.default_rng(0)
    params = {'a': rng.normal(size=(3, 4)), 'b': rng.normal(size=5)}
    opt_j, opt_t = optax.adamw(1e-2, b2=0.9), adamw(1e-2, b2=0.9)
    p_j, p_t = dict(params), {k: torch.tensor(v) for k, v in params.items()}
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    for _ in range(4):
        grads = {k: rng.normal(size=v.shape) for k, v in params.items()}
        u_j, s_j = opt_j.update(grads, s_j, p_j)
        u_t, s_t = opt_t.update({k: torch.tensor(g) for k, g in grads.items()}, s_t, p_t)
        p_j = optax.apply_updates(p_j, u_j)
        p_t = {k: p_t[k] + u_t[k] for k in p_t}
    for k in params:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), rtol=1e-12)
