"""The walker chunks of the local energy, the gradient and pretraining.

Chunked against unchunked in the port at float64 within 1e-12 (the same
per-walker arithmetic in smaller batches; a sum over the chunks in place of
one sum): the local energy and its terms, all-electron and with an ECP
(whose quadrature rotations are drawn for the whole batch), the VMC gradient
with KFAC's factor sums, pretraining's gradient for one state and for two.
Then the port with the JAX package's variables set against the JAX loss run
with the same variables (1e-10, the loss tests' tolerance), on the small
PsiFormer cut to one layer, LiH, 8 walkers.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from torch_parity import (
    SMALL,
    assert_close,
    grads_by_jax_path,
    jax_batch,
    jax_model,
    molecule,
    torch_model,
    torch_phys_conf,
    walkers,
)

import deepqmc_tpu_torch as dqt
from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import median_log_squeeze_and_mask as jax_clip_fn
from deepqmc_tpu_torch.kfac import KFAC
from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
from deepqmc_tpu_torch.loss.energy import compute_local_energy
from deepqmc_tpu_torch.optimizer import GradientTransformation
from deepqmc_tpu_torch.pretrain.pretraining import pretrain_update
from deepqmc_tpu_torch.utils import ConstantSchedule, chunk_size
from deepqmc_tpu_torch.wf import StateStack

REL = 1e-12
B = 8
CHUNKS = [1, 3, 4]  # 3: the largest divisor of 8 at most 3 is 2


@pytest.fixture(scope='module')
def model():
    hamil_j, ansatz, params = jax_model('LiH', seed=0, n_interactions=1)
    hamil, wf = torch_model('LiH', params, overrides={'n_interactions': 1})
    r = walkers(hamil_j, 'init_sample', n=B, seed=0)
    return dict(hamil_j=hamil_j, ansatz=ansatz, params=params, hamil=hamil, wf=wf, r=r,
                pc=torch_phys_conf(hamil, r))


def test_chunk_size_is_the_largest_divisor(monkeypatch):
    assert [chunk_size(12, c) for c in (0, 1, 5, 6, 7, 12, 100)] == [12, 1, 4, 6, 6, 12, 12]
    monkeypatch.setenv('SOME_CHUNK', '5')
    assert chunk_size(12, None, 'SOME_CHUNK') == 4
    assert chunk_size(12, None, 'UNSET_CHUNK') == 12
    assert chunk_size(12, None, 'UNSET_CHUNK', default=6) == 6


def _assert_energies(got, want):
    assert_close(got[0], want[0], REL, 'E_loc')
    assert set(got[1]) == set(want[1])
    for k, v in want[1].items():
        assert_close(got[1][k], v, REL, k)


@pytest.mark.parametrize('chunk', CHUNKS)
def test_local_energy_chunks(model, chunk):
    whole = compute_local_energy(model['hamil'], model['wf'], model['pc'], walker_chunk=0)
    _assert_energies(compute_local_energy(model['hamil'], model['wf'], model['pc'],
                                          walker_chunk=chunk), whole)


def test_local_energy_chunks_with_an_ecp():
    """LiH with Li under ccECP: the rotations of the whole batch, drawn once
    from the Hamiltonian's generator, are cut with the walkers."""
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('LiH'), ecp_type='ccECP')
    wf = dqt.psiformer_ansatz(hamil, **{**SMALL, 'n_interactions': 1}).double()
    pc = hamil.init_sample(torch.Generator().manual_seed(0), B)
    out = []
    for chunk in (0, 3):
        hamil._nl_gens.clear()  # each run draws its rotations from a fresh generator
        out.append(compute_local_energy(hamil, wf, pc, walker_chunk=chunk))
    assert (out[0][1]['hamil/V_nl'] != 0).all()  # each walker's nonlocal term
    _assert_energies(out[1], out[0])


def _loss_and_kfac(hamil, wf, pc, **chunks):
    loss = create_loss_fn(hamil, wf, median_log_squeeze_and_mask, **chunks)
    kfac = KFAC(loss, learning_rate_schedule=ConstantSchedule(0.05))
    kfac.init(pc)
    return loss, kfac


@pytest.mark.parametrize('chunk', CHUNKS)
def test_gradient_and_kfac_factor_chunks(model, chunk):
    hamil, wf, pc = model['hamil'], model['wf'], model['pc']
    weight = torch.linspace(0.5, 1.5, B, dtype=torch.float64)
    out = []
    for grad_chunk in (0, chunk):
        loss, kfac = _loss_and_kfac(hamil, wf, pc, grad_walker_chunk=grad_chunk)
        out.append(loss.value_grad_and_taps(pc, weight))
    (want_loss, _), want_grads, want_sums = out[0]
    (got_loss, _), got_grads, got_sums = out[1]
    assert_close(got_loss, want_loss, REL, 'loss')
    assert set(got_grads) == set(want_grads)
    for k, g in want_grads.items():
        assert_close(got_grads[k], g, REL, k)
    assert set(got_sums) == set(want_sums) == {m.path for m in kfac.metas}
    for path, (A, G) in want_sums.items():
        assert_close(got_sums[path][0], A, REL, f'{path} A')
        assert_close(got_sums[path][1], G, REL, f'{path} G')


def test_factor_sums_leave_out_layers_without_rows():
    """Triplet H2 has no down-spin electron: the loss's factor sums leave out
    the layer that would act on its rows, as KFAC's discovered layers do."""
    hamil = dqt.MolecularHamiltonian(mol=molecule(dqt, 'H2_triplet'))
    wf = dqt.psiformer_ansatz(hamil, **{**SMALL, 'n_interactions': 1}).double()
    pc = hamil.init_sample(torch.Generator().manual_seed(0), 4)
    loss, kfac = _loss_and_kfac(hamil, wf, pc, grad_walker_chunk=2)
    _, _, sums = loss.value_grad_and_taps(pc, torch.ones(4, dtype=torch.float64))
    paths = {m.path for m in kfac.metas}
    assert set(sums) == paths
    assert len(paths) < len(set(loss.dense_paths[0].values()))


def _target(confs, conf_coeffs, phys_conf):
    """A pretraining target that depends on each walker alone, [B, 1, n, n]."""
    x = phys_conf.r.sum(-1)
    return torch.tanh(x[:, :, None] * torch.linspace(-1, 1, x.shape[-1], dtype=x.dtype))[:, None]


SGD = GradientTransformation(lambda params: (),
                             lambda grads, state, params=None: ({k: -g for k, g in grads.items()},
                                                               state))


@pytest.mark.parametrize('n_states', [1, 2])
def test_pretraining_gradient_chunks(model, n_states):
    """One plain gradient step (the update is minus the gradient) of the
    orbital loss: the loss, the per-walker losses and every moved parameter."""
    hamil, base = model['hamil'], model['wf']
    r = model['pc'].r
    if n_states == 1:
        pc, confs = model['pc'], torch.zeros(1, 1, 4, dtype=torch.long)
    else:
        pc = model['pc'].replace(r=torch.stack([r, r.flip(0) + 0.1]),
                                 mol_idx=torch.zeros(2, B, dtype=torch.long))
        confs = torch.zeros(1, 2, 1, 4, dtype=torch.long)
    out = []
    for chunk in (0, 4):
        wf = copy.deepcopy(base)
        if n_states == 2:
            wf = StateStack([wf, copy.deepcopy(base)])
            with torch.no_grad():
                for p in wf[1].parameters():
                    p.mul_(1.01)
        before = copy.deepcopy(wf.state_dict())
        _, loss, losses = pretrain_update(hamil, wf, _target, confs, confs, pc, SGD, (),
                                          walker_chunk=chunk)
        out.append((loss, losses, {k: v - before[k] for k, v in wf.state_dict().items()}))
    assert_close(out[1][0], out[0][0], REL, 'loss')
    assert_close(out[1][1], out[0][1], REL, 'per-walker losses')
    for k, step in out[0][2].items():
        assert_close(out[1][2][k], step, REL, k)


def test_chunks_from_the_environment_match_jax(model, monkeypatch):
    """The port's loss, local energies and gradient with both chunks left to
    the JAX package's variables (4 walkers each) against the JAX loss run
    with the same variables."""
    monkeypatch.setenv('DEEPQMC_TPU_ELOC_WALKER_CHUNK', '4')
    monkeypatch.setenv('DEEPQMC_TPU_GRAD_WALKER_CHUNK', '4')
    loss_j = jax_create_loss_fn(model['hamil_j'], model['ansatz'], jax_clip_fn)
    (want_loss, (want_E, _, _)), (want_grads,) = jax.jit(loss_j.value_and_grad)(
        [model['params']], jax.random.PRNGKey(0), jax_batch(model['hamil_j'], model['r']))
    loss_t = create_loss_fn(model['hamil'], model['wf'], median_log_squeeze_and_mask)
    (loss, (E, _, _)), grads = loss_t.value_and_grad(model['pc'], torch.ones(B, dtype=torch.float64))
    assert_close(loss, want_loss, 1e-10, 'loss')
    assert_close(E, np.asarray(want_E)[0, 0], 1e-10, 'E_loc')
    for (path, name), g in grads_by_jax_path(grads, model['wf']).items():
        assert_close(g, want_grads[path][name], 1e-10, f'{path}/{name}')
