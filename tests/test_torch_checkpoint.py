"""The port's checkpoints: a train state after two training steps (the
wave function's ``state_dict``, the combined sampler's state with its ``Psi``,
the KFAC or Adam state) written by ``CheckpointStore`` and read back bit for
bit, also by ``torch.load(..., weights_only=True)``; the store keeps and drops
the same file names as the JAX package's ``CheckpointStore`` for the same
updates."""

import sys

import jax.numpy as jnp
import pytest
import torch

import deepqmc_tpu_torch as dqt
from deepqmc_tpu.log import CheckpointStore as JaxCheckpointStore
from deepqmc_tpu.types import TrainState as JaxTrainState
from deepqmc_tpu_torch.fit import TrainState
from deepqmc_tpu_torch.log import CheckpointStore
from deepqmc_tpu_torch.types import Psi

TINY = dict(n_determinants=2, embedding_dim=16, n_interactions=1, num_heads=2)


def _train_state(optimizer, sampler=None):
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    wf = dqt.psiformer_ansatz(hamil, **TINY)
    *_, (_, state, _, _) = dqt.fit.train(hamil, wf, n_walkers=16, steps=2, decorr=2,
                                         optimizer=optimizer, sampler=sampler, device='cpu')
    return state


def _assert_equal(got, want, where=''):
    """Trees of dicts, tuples and leaves equal, tensors bit for bit."""
    assert type(got) is type(want) or isinstance(want, dict), (where, type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_equal(got[k], want[k], f'{where}/{k}')
    elif isinstance(want, tuple):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f'{where}[{i}]')
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.device == want.device, where
        assert torch.equal(got, want), where
    else:
        assert got == want, where


@pytest.mark.parametrize('optimizer, sampler', [
    ('kfac', None), ('adam', None), ('kfac', 'decorr_langevin'),
])
def test_checkpoint_round_trip_is_bit_equal(optimizer, sampler, tmp_path):
    state = _train_state(optimizer, sampler)
    store = CheckpointStore(tmp_path, device='cpu')
    store.update(2, state, 0.5)
    (path,) = tmp_path.glob('chkpt-*.pt')
    assert path.name == 'chkpt-2.pt' and store.chkpts[0].loss == 0.5
    step, loaded = store.last
    assert step == 2 and isinstance(loaded, TrainState)
    assert isinstance(loaded.sampler['elec']['psi'], Psi)
    _assert_equal(loaded.sampler, state.sampler, 'sampler')
    _assert_equal(loaded.params, dict(state.params), 'params')
    _assert_equal(loaded.opt, state.opt, 'opt')
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {'step', 'sampler', 'params', 'opt'}
    assert all(torch.equal(raw['params'][k], v) for k, v in state.params.items())


def test_checkpoint_holds_the_state_of_its_step(tmp_path):
    """The store copies: parameters changed in place after ``update`` do not
    reach the checkpoint written at close."""
    state = _train_state('adam')
    store = CheckpointStore(tmp_path, interval=10)
    store.update(0, state)
    store.update(1, state)
    before = {k: v.clone() for k, v in state.params.items()}
    for v in state.params.values():
        v.add_(1.0)
    store.close()
    _, loaded = CheckpointStore.load(tmp_path / 'chkpt-1.pt')
    _assert_equal(loaded.params, before, 'params')


def _jax_state():
    return JaxTrainState({'elec': {'r': jnp.zeros(3)}}, {'w': jnp.ones(2)}, None)


@pytest.mark.parametrize('interval, size', [(1, sys.maxsize), (3, sys.maxsize), (3, 2), (1, 1),
                                            (4, 3)])
def test_store_keeps_the_files_jax_keeps(interval, size, tmp_path):
    """Updates at steps 0..12 (the first one kept always) and a close: the
    same files and the same list of checkpoints as the JAX package's store;
    files of an earlier run are removed at start."""
    state = _train_state('adam')
    names = {}
    for pkg, store_cls, st in (('jax', JaxCheckpointStore, _jax_state()),
                               ('port', CheckpointStore, state)):
        workdir = tmp_path / pkg
        workdir.mkdir()
        (workdir / 'chkpt-99.pt').write_bytes(b'')
        store = store_cls(str(workdir), interval=interval, size=size)
        for step in range(13):
            store.update(step, st, float(step))
        kept = [c.step for c in store.chkpts]
        store.close()
        names[pkg] = (sorted(p.name for p in workdir.iterdir()), kept,
                      [c.step for c in store.chkpts])
    assert names['port'] == names['jax']
    assert 'chkpt-0.pt' in names['port'][0] and 'chkpt-99.pt' not in names['port'][0]


@pytest.mark.parametrize('name', ['chkpt-0.pt', 'chkpt-1000.pt', 'run/chkpt-42.pt', 'bad.pt'])
def test_step_from_filename_as_jax(name):
    try:
        want = JaxCheckpointStore.extract_step_from_filename(name)
    except ValueError:
        with pytest.raises(ValueError):
            CheckpointStore.extract_step_from_filename(name)
    else:
        assert CheckpointStore.extract_step_from_filename(name) == want
