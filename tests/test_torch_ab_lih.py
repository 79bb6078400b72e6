"""The port's LiH convergence gate (``deepqmc_tpu_torch.ab_lih_convergence``)
against the JAX package's script (``scripts/ab_lih_convergence.py``).

Its variants set the same switches, name by name; its commands are the
script's progression-config-2 run on the port's command line; its readers
give the script's estimates (the mean with the spread of the step means, and
the 10-MAD robust mean) from the same local energies, here written by a one-
or two-step run on the CPU at a tiny size and, for the script's readers, into
the ``result.h5`` they read.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from deepqmc_tpu_torch import ab_lih_convergence as gate

ROOT = Path(__file__).resolve().parent.parent
TINY = ['task.electron_batch_size=16', '+task.max_eq_steps=2', 'ansatz.n_determinants=2',
        'ansatz.omni_factory.embedding_dim=16', 'ansatz.omni_factory.gnn_factory.n_interactions=1']


@pytest.fixture(scope='module')
def script():
    spec = importlib.util.spec_from_file_location('jax_ab_lih',
                                                  ROOT / 'scripts' / 'ab_lih_convergence.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_variants_set_the_scripts_switches(script):
    assert gate.VARIANTS == script.VARIANTS
    assert gate.REFERENCE == script.REFERENCE


def test_commands_are_the_scripts_run(tmp_path):
    train, evaluate = gate.commands(tmp_path / 'v', 1000, 200, 500, 5, seed=3)
    assert train[1:3] == ['-m', 'deepqmc_tpu_torch']
    for arg in ('hamil/mol=LiH', 'task.electron_batch_size=1024', 'task.steps=1000',
                'task.pretrain_steps=500', '+task.fit_block_size=10',
                'task.opt.kfac.inverse_update_period=5', 'task.seed=3',
                f'--workdir={tmp_path / "v"}'):
        assert arg in train
    for arg in ('task=evaluate', f'task.restdir={tmp_path / "v"}/training', '+task.steps=200',
                f'--workdir={tmp_path / "v"}_eval', *gate.SAMPLE_SINK):
        assert arg in evaluate


@pytest.fixture(scope='module')
def tiny_run(tmp_path_factory):
    """A two-step training and a two-step evaluation of ``baseline`` on the CPU."""
    wd = tmp_path_factory.mktemp('ab_lih')
    out = wd / 'rows.jsonl'
    gate.main(['--steps', '2', '--eval-steps', '2', '--pretrain-steps', '1', '--variants',
               'baseline', '--device', 'cpu', '--workdir', str(wd), '--out', str(out), *TINY])
    return wd / 'baseline_eval', [json.loads(line) for line in out.read_text().splitlines()]


def test_readers_parse_a_tiny_run(tiny_run, script):
    import h5py

    run_dir, rows = tiny_run
    files = sorted((run_dir / 'evaluation' / 'local_energy').glob('*.npy'))
    assert len(files) == 2
    samples = np.stack([np.load(f) for f in files])
    assert samples.shape[0] == 2 and samples.size == 2 * 16 and np.isfinite(samples).all()
    (row,) = rows
    assert row['variant'] == 'baseline' and row['steps'] == 2
    assert (row['energy'], row['err']) == gate.final_energy(run_dir)
    assert (row['energy_robust'], row['err_robust']) == gate.robust_energy(run_dir)
    # the script's readers on the same samples, in the result.h5 they read
    h5_dir = run_dir.parent / 'h5'
    (h5_dir / 'evaluation').mkdir(parents=True)
    with h5py.File(h5_dir / 'evaluation' / 'result.h5', 'w') as f:
        f['local_energy/samples'] = samples
    np.testing.assert_allclose(gate.final_energy(run_dir), script.final_energy(h5_dir),
                               rtol=1e-12)
    np.testing.assert_allclose(gate.robust_energy(run_dir), script.robust_energy(h5_dir),
                               rtol=1e-12)


def test_a_variant_with_levers_is_evaluated_again_with_every_lever_off(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(gate, 'run', lambda cmd, env, timeout: calls.append((cmd, env)))
    monkeypatch.setattr(gate, 'final_energy',
                        lambda wd: (-8.0 if str(wd).endswith('_off') else -8.1, 1e-3))
    monkeypatch.setattr(gate, 'robust_energy', lambda wd: (-8.05, 2e-4))
    out = tmp_path / 'rows.jsonl'
    gate.main(['--variants', 'r4_all,baseline', '--device', 'cpu', '--workdir', str(tmp_path),
               '--out', str(out)])
    (_, r4_env), (r4_eval, _), (r4_off, off_env), (_, _), (base_eval, _) = calls
    assert r4_env == gate.VARIANTS['r4_all']['env'] and off_env == gate.LEVERS_OFF
    assert r4_off[:-1] == r4_eval[:-1]  # the same evaluation of the same checkpoint
    assert r4_off[-1] == f'--workdir={tmp_path / "r4_all"}_eval_off'
    r4, base = (json.loads(line) for line in out.read_text().splitlines())
    assert (r4['energy'], r4['energy_levers_off']) == (-8.1, -8.0)
    # baseline has no lever on: its evaluation is the lever-off one
    assert (base['energy'], base['energy_levers_off']) == (-8.1, -8.1)
    assert [gate.levers_on(v['env']) for v in gate.VARIANTS.values()] == \
        [False, False, True, True, True, True, True, True]


def test_the_card_refuses_samp_bf16(tmp_path):
    with pytest.raises(SystemExit, match="samp_bf16.*'default'"):
        gate.main(['--variants', 'baseline,samp_bf16', '--workdir', str(tmp_path)])
    assert not list(tmp_path.iterdir())  # refused before any run
