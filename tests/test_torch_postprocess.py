"""The port's offline tools against the JAX package's.

``oscillator_strength.compute_oscillator_strength`` against
``deepqmc_tpu.oscillator_strength`` at float64 on seeded samples, with and
without masks (1e-12; both keep the JAX algebra, NaN diagonal of the error
included), and ``postprocess`` (``read_workdir``, ``read_and_convert_result``)
against ``deepqmc_tpu.postprocess`` on the same ``result.h5`` files of a
single-node and a two-node working directory (exact), with the readers'
refusals of malformed directories.
"""

import numpy as np
import pytest
import torch

from deepqmc_tpu.oscillator_strength import compute_oscillator_strength as jax_oscillator
from deepqmc_tpu_torch import postprocess
from deepqmc_tpu_torch.oscillator_strength import compute_oscillator_strength


def _samples(seed, n_states=3, n=200):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n_states, n)) - np.arange(n_states)[:, None]
    ratios = rng.normal(size=(n_states, n_states, n)) * 0.1 + 0.3
    rs = rng.normal(size=(n_states, n, 4, 3)) + 0.2
    return e, ratios, rs


@pytest.mark.parametrize('masked', [False, True])
def test_oscillator_strength_matches_jax(masked):
    e, ratios, rs = _samples(0)
    masks = {}
    if masked:
        rng = np.random.default_rng(1)
        masks = dict(local_energies_mask=rng.uniform(size=e.shape) > 0.1,
                     ratios_mask=rng.uniform(size=ratios.shape) > 0.1)
    got = compute_oscillator_strength(*map(torch.tensor, (e, ratios, rs)),
                                      **{k: torch.tensor(v) for k, v in masks.items()})
    want = jax_oscillator(e, ratios, rs, **masks)
    for (g_mean, g_err), (w_mean, w_err) in zip(got, want):
        np.testing.assert_allclose(g_mean.numpy(), np.asarray(w_mean), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(g_err.numpy(), np.asarray(w_err), rtol=1e-12, atol=1e-14)
    (f, f_err), _, (ex, _) = got
    assert np.isnan(np.diagonal(f_err.numpy())).all()  # 0/0 on the zero-gap diagonal
    np.testing.assert_array_equal(np.diagonal(f.numpy()), 0.0)
    np.testing.assert_allclose(ex.numpy(), -ex.numpy().T)


def _write(subdir, samples, mol_idxs, last_chkpt):
    h5py = pytest.importorskip('h5py')
    subdir.mkdir(parents=True)
    with h5py.File(subdir / 'result.h5', 'w') as f:
        f['local_energy/samples'] = samples
        f['mol_idxs'] = mol_idxs
    (subdir / f'chkpt-{last_chkpt}.pt').write_bytes(b'x')
    (subdir / 'chkpt-2.pt').write_bytes(b'x')


@pytest.mark.parametrize('nodes', [1, 2])
def test_workdir_round_trip_matches_jax(tmp_path, nodes):
    rng = np.random.default_rng(nodes)
    for i in range(nodes):
        name = 'training' if nodes == 1 else f'training_{i}'
        _write(tmp_path / name, rng.normal(size=(6 + i, 1, 4)),
               np.tile(np.arange(2), 3 + i).reshape(-1, 1)[:6 + i], 5)
    from deepqmc_tpu import postprocess as jax_postprocess  # imports h5py

    keys = ['local_energy/samples', 'mol_idxs']
    got, got_iter = postprocess.read_workdir(tmp_path, keys)
    want, want_iter = jax_postprocess.read_workdir(tmp_path, keys)
    assert got_iter == want_iter == 5
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    got = postprocess.read_and_convert_result(tmp_path, 'local_energy/samples')
    want = jax_postprocess.read_and_convert_result(tmp_path, 'local_energy/samples')
    assert got['local_energy/samples'].shape == want['local_energy/samples'].shape
    np.testing.assert_array_equal(got['local_energy/samples'], want['local_energy/samples'])


def test_workdir_reader_refusals(tmp_path):
    assert postprocess.read_workdir(tmp_path, ['x']) == ({}, None)
    (tmp_path / 'training').mkdir()
    (tmp_path / 'evaluation').mkdir()
    with pytest.raises(ValueError, match='both evaluation and training'):
        postprocess.read_workdir(tmp_path, ['x'])
    (tmp_path / 'evaluation').rmdir()
    (tmp_path / 'training_1').mkdir()
    with pytest.raises(ValueError, match='Mix of single and multi node'):
        postprocess.read_workdir(tmp_path, ['x'])
