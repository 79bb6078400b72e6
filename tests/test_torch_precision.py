"""The precision levers of the port against the JAX package's.

- The matmul-precision contexts (``utils.sampling_precision_ctx``,
  ``grad_precision_ctx`` and the global pin ``set_true_fp32``): the JAX labels
  map to PyTorch's settings, the setting is restored after an exception, the
  local energy runs at 'highest' inside both, and 'inherit' changes nothing.
- The Jacobian store (``DEEPQMC_TPU_JAC_DTYPE=bf16``) and the bf16 Jacobian
  contractions (``DEEPQMC_TPU_JAC_MATMUL``) on one dense op after one
  elementwise op, held to the JAX interpreter's FL values (``fwdlap.
  _interpret``) with both sides under the same environment, at float32: the
  Jacobians are bf16 on both sides and within one bf16 spacing (2^-8 of the
  value) of each other, as float32 sums taken in other orders may round to
  neighbouring bf16 values; the primal and the Laplacian stay float32 and
  agree to float32 rounding (rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one intra-op thread per pytest worker)

import deepqmc_tpu_torch as dqt
from deepqmc_tpu import fwdlap as jfl
from deepqmc_tpu_torch import fwdlap as fl
from deepqmc_tpu_torch import utils

BF16_SPACING = 2.0**-8
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _restore_precision():
    saved = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(saved)


@pytest.mark.parametrize('label, want', [('highest', 'highest'), ('high', 'high'),
                                         ('default', 'medium')])
@pytest.mark.parametrize('ctx, switch', [
    (utils.sampling_precision_ctx, 'DEEPQMC_TPU_SAMPLING_PRECISION'),
    (utils.grad_precision_ctx, 'DEEPQMC_TPU_GRAD_PRECISION'),
])
def test_contexts_map_the_jax_labels(monkeypatch, ctx, switch, label, want):
    monkeypatch.setenv(switch, label)
    torch.set_float32_matmul_precision('highest')
    with ctx():
        assert torch.get_float32_matmul_precision() == want
        assert torch.backends.cuda.matmul.allow_tf32 == (want != 'highest')
    assert torch.get_float32_matmul_precision() == 'highest'
    assert not torch.backends.cuda.matmul.allow_tf32


def test_contexts_default_to_highest_and_inherit_changes_nothing(monkeypatch):
    for switch in ('DEEPQMC_TPU_SAMPLING_PRECISION', 'DEEPQMC_TPU_GRAD_PRECISION'):
        monkeypatch.delenv(switch, raising=False)
    torch.set_float32_matmul_precision('high')
    for ctx in (utils.sampling_precision_ctx, utils.grad_precision_ctx):
        with ctx():
            assert torch.get_float32_matmul_precision() == 'highest'
        assert torch.get_float32_matmul_precision() == 'high'
    monkeypatch.setenv('DEEPQMC_TPU_SAMPLING_PRECISION', 'inherit')
    monkeypatch.setenv('DEEPQMC_TPU_GRAD_PRECISION', 'inherit')
    for ctx in (utils.sampling_precision_ctx, utils.grad_precision_ctx):
        with ctx():
            assert torch.get_float32_matmul_precision() == 'high'
        assert torch.get_float32_matmul_precision() == 'high'


def test_context_restores_after_an_exception_and_rejects_unknown_labels(monkeypatch):
    monkeypatch.setenv('DEEPQMC_TPU_GRAD_PRECISION', 'default')
    torch.set_float32_matmul_precision('highest')
    with pytest.raises(KeyError):
        with utils.grad_precision_ctx():
            assert torch.get_float32_matmul_precision() == 'medium'
            raise KeyError('inside')
    assert torch.get_float32_matmul_precision() == 'highest'
    monkeypatch.setenv('DEEPQMC_TPU_GRAD_PRECISION', 'bfloat16')
    with pytest.raises(ValueError, match='DEEPQMC_TPU_GRAD_PRECISION'):
        utils.grad_precision_ctx()


@pytest.mark.parametrize('switch', ['DEEPQMC_TPU_SAMPLING_PRECISION',
                                    'DEEPQMC_TPU_GRAD_PRECISION',
                                    'DEEPQMC_TPU_MATMUL_PRECISION'])
def test_default_label_is_refused_where_cuda_is_present(monkeypatch, switch):
    """cuBLAS runs torch's 'medium' as TF32, so 'default' (one bf16 pass in
    JAX) would run 'high' under another name on the card."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setenv(switch, 'default')
    torch.set_float32_matmul_precision('highest')
    call = {'DEEPQMC_TPU_SAMPLING_PRECISION': utils.sampling_precision_ctx,
            'DEEPQMC_TPU_GRAD_PRECISION': utils.grad_precision_ctx,
            'DEEPQMC_TPU_MATMUL_PRECISION': utils.set_true_fp32}[switch]
    with pytest.raises(ValueError, match=f"{switch}='default'.*TF32"):
        call()
    assert torch.get_float32_matmul_precision() == 'highest'


def test_global_pin_reads_the_matmul_precision_switch(monkeypatch):
    monkeypatch.setenv('DEEPQMC_TPU_MATMUL_PRECISION', 'high')
    utils.set_true_fp32()
    assert torch.get_float32_matmul_precision() == 'high'
    monkeypatch.delenv('DEEPQMC_TPU_MATMUL_PRECISION')
    utils.set_true_fp32()
    assert torch.get_float32_matmul_precision() == 'highest'
    assert not torch.backends.cudnn.allow_tf32


def test_active_levers_name_what_is_on(monkeypatch):
    for name in ('DEEPQMC_TPU_MATMUL_PRECISION', 'DEEPQMC_TPU_SAMPLING_PRECISION',
                 'DEEPQMC_TPU_GRAD_PRECISION', 'DEEPQMC_TPU_JAC_DTYPE',
                 'DEEPQMC_TPU_JAC_MATMUL'):
        monkeypatch.delenv(name, raising=False)
    assert utils.active_levers() == {}
    monkeypatch.setenv('DEEPQMC_TPU_SAMPLING_PRECISION', 'inherit')
    monkeypatch.setenv('DEEPQMC_TPU_JAC_DTYPE', 'bf16')
    # the contractions follow a bf16 store unless told otherwise, as in JAX
    assert utils.active_levers() == {'DEEPQMC_TPU_JAC_DTYPE': 'bf16',
                                     'DEEPQMC_TPU_JAC_MATMUL': 'bf16'}
    monkeypatch.setenv('DEEPQMC_TPU_JAC_MATMUL', 'f32')
    monkeypatch.setenv('DEEPQMC_TPU_GRAD_PRECISION', 'high')
    assert utils.active_levers() == {'DEEPQMC_TPU_GRAD_PRECISION': 'high',
                                     'DEEPQMC_TPU_JAC_DTYPE': 'bf16'}


def test_local_energy_runs_at_highest_inside_both_contexts(monkeypatch):
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    wf = dqt.psiformer_ansatz(hamil, n_determinants=1, embedding_dim=8, n_interactions=1,
                              num_heads=2)
    seen = []
    wf.register_forward_pre_hook(
        lambda m, args: seen.append(torch.get_float32_matmul_precision())
        if fl.is_fl(args[0].r) else None)
    pc = dqt.PhysicalConfiguration(torch.as_tensor(hamil.mol.coords, dtype=torch.float32),
                                   torch.randn(3, 2, 3), torch.zeros(3, dtype=torch.long))
    monkeypatch.setenv('DEEPQMC_TPU_SAMPLING_PRECISION', 'high')
    monkeypatch.setenv('DEEPQMC_TPU_GRAD_PRECISION', 'default')
    for ctx, inside in ((utils.sampling_precision_ctx, 'high'),
                        (utils.grad_precision_ctx, 'medium')):
        with ctx(), torch.inference_mode():
            assert torch.get_float32_matmul_precision() == inside
            hamil.local_energy(wf, pc)
            assert torch.get_float32_matmul_precision() == inside
    assert seen == ['highest', 'highest']


# --- the Jacobian store and contractions on FL ops ----------------------------

N_IN, N_OUT = 6, 5
_rng = np.random.default_rng(11)
W = _rng.normal(size=(N_IN, N_OUT)).astype(np.float32)
X = _rng.normal(size=(N_IN,)).astype(np.float32)


def _jax_fl(f):
    """The JAX interpreter's FL value of ``f`` at X (direction axis first)."""
    x = jnp.asarray(X)
    closed = jax.make_jaxpr(f)(x)
    seed = jfl.FL(x, jnp.eye(N_IN, dtype=x.dtype), jnp.zeros_like(x))
    (out,) = jfl._interpret(closed.jaxpr, closed.consts, [seed], N_IN)
    return out


def _port_fl(f):
    with fl.jac_levers(), torch.inference_mode():
        out = f(fl.FL.seed(torch.as_tensor(X)[None]))
        return out.x[0], out.stored_jac[0], out.lap[0]


@pytest.mark.parametrize('matmul', ['', 'f32', 'bf16'])
@pytest.mark.parametrize('op', ['elementwise', 'dense'])
def test_bf16_store_matches_jax_interpreter(monkeypatch, op, matmul):
    monkeypatch.setenv('DEEPQMC_TPU_JAC_DTYPE', 'bf16')
    monkeypatch.setenv('DEEPQMC_TPU_JAC_MATMUL', matmul)
    if op == 'elementwise':
        want = _jax_fl(jnp.tanh)
        got = _port_fl(fl.tanh)
    else:
        w = jnp.asarray(W)
        want = _jax_fl(lambda x: jnp.tanh(x) @ w)
        got = _port_fl(lambda h: fl.tanh(h) @ torch.as_tensor(W))
    assert want.jac.dtype == jnp.bfloat16 and got[1].dtype == torch.bfloat16
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want.x), rtol=RTOL)
    jac_j = np.asarray(want.jac.astype(jnp.float32), np.float64)
    jac_t = got[1].float().numpy().astype(np.float64)
    assert np.all(np.abs(jac_t - jac_j) <= BF16_SPACING * np.abs(jac_j) + 1e-7)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want.lap), rtol=RTOL, atol=RTOL)


def test_bf16_store_keeps_primal_and_laplacian_and_upcasts_at_exit(monkeypatch):
    monkeypatch.setenv('DEEPQMC_TPU_JAC_DTYPE', 'bf16')
    x = torch.as_tensor(X)[None].double()

    def f(h):
        y = fl.tanh(h @ torch.as_tensor(W, dtype=torch.float64))
        assert y.stored_jac.dtype == torch.bfloat16 and y.jac.dtype == torch.float64
        assert y.x.dtype == torch.float64 and y.lap.dtype == torch.float64
        return (y * y).sum(-1)

    lap, jac = fl.forward_laplacian(f)(x)
    assert lap.dtype == torch.float64 and jac.dtype == torch.float64
    monkeypatch.setenv('DEEPQMC_TPU_JAC_DTYPE', 'f32')
    lap32, jac32 = fl.forward_laplacian(lambda h: (fl.tanh(
        h @ torch.as_tensor(W, dtype=torch.float64)) ** 2).sum(-1))(x)
    torch.testing.assert_close(jac, jac32, rtol=5e-2, atol=5e-2)
    # outside a pass the levers are off: FL values keep the primal's dtype
    assert fl.FL.seed(x).stored_jac.dtype == torch.float64


def test_levers_reach_every_forward_laplacian_path(monkeypatch):
    """The force estimators' tangent pass, the walker chunks and the block
    path's plain version run under the levers like the local energy: each
    agrees with the unchunked local energy under the same levers."""
    monkeypatch.setenv('DEEPQMC_TPU_JAC_DTYPE', 'bf16')
    from deepqmc_tpu_torch.loss.energy import compute_local_energy

    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('LiH'))
    wf = dqt.psiformer_ansatz(hamil, n_determinants=2, embedding_dim=16, n_interactions=1,
                              num_heads=2, seed=0)
    pc = dqt.PhysicalConfiguration(torch.as_tensor(hamil.mol.coords, dtype=torch.float32),
                                   torch.randn(4, 4, 3, generator=torch.Generator()
                                               .manual_seed(0)),
                                   torch.zeros(4, dtype=torch.long))
    seen = []
    wf.register_forward_pre_hook(
        lambda m, args: seen.append(fl.levers()) if fl.is_fl(args[0].r) else None)
    with torch.inference_mode():
        whole, _ = compute_local_energy(hamil, wf, pc)
        chunks, _ = compute_local_energy(hamil, wf, pc, walker_chunk=2)
    torch.testing.assert_close(chunks, whole, rtol=1e-5, atol=1e-5)
    from deepqmc_tpu_torch.force import log_psi_tangents

    with torch.no_grad():
        log_psi_tangents(wf, pc)
    assert seen and all(lv == fl.Levers(torch.bfloat16, True) for lv in seen)
