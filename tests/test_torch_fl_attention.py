"""The port's forward-Laplacian attention core against the JAX package.

The plain version (the CPU path of ``deepqmc_tpu_torch.ops.mha_core_fl``) is
held to JAX ``mha_core_fl`` and to the Pallas kernel ``_pallas_blocked`` in
interpret mode, on the same seeded inputs, at float64.  Relative tolerance
1e-10: the same algebra in another summation order (einsum vs dot_general),
so only float64 rounding separates them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepqmc_tpu.ops.fl_attention import _pallas_blocked
from deepqmc_tpu.ops.fl_attention import mha_core_fl as jax_mha_core_fl
from deepqmc_tpu_torch.ops import fl_attention

B, N, H, DH, K = 3, 4, 2, 8, 12
RTOL = 1e-10


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    prim = [rng.normal(size=(B, N, H, DH)) for _ in range(3)]
    jacs = [rng.normal(size=(B, K, N, H, DH)) for _ in range(3)]
    laps = [rng.normal(size=(B, N, H, DH)) for _ in range(3)]
    return [*prim, *jacs, *laps]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize('seed', [0, 1])
def test_plain_matches_jax_twin(seed):
    args = _inputs(seed)
    want = jax.vmap(jax_mha_core_fl)(*map(jnp.asarray, args))
    got = fl_attention.mha_core_fl_plain(*(torch.as_tensor(a) for a in args))
    _close([g.numpy() for g in got], want)


def test_plain_matches_interpret_mode_kernel():
    args = _inputs(2)
    want = _pallas_blocked(*map(jnp.asarray, args), interpret=True)
    got = fl_attention.mha_core_fl_plain(*(torch.as_tensor(a) for a in args))
    _close([g.numpy() for g in got], want)


def test_wrapper_takes_plain_version_on_cpu():
    args = [torch.as_tensor(a) for a in _inputs(3)]
    before = fl_attention.mha_core_fl.launches
    got = fl_attention.mha_core_fl(*args)
    want = fl_attention.mha_core_fl_plain(*args)
    assert fl_attention.mha_core_fl.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('fault', ['dtype', 'shape', 'layout', 'width'])
def test_kernel_input_checks_reject(fault):
    args = [torch.as_tensor(a, dtype=torch.float32) for a in _inputs(4)]
    fl_attention.validate(*args)
    if fault == 'width':  # dh not a multiple of 4 (float4 rows)
        args = [a[..., :6].contiguous() for a in args]
    elif fault == 'dtype':
        args[0] = args[0].double()
    elif fault == 'shape':
        args[4] = args[4][:, :-1]
    else:
        args[3] = args[3].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        fl_attention.validate(*args)


@pytest.fixture
def fresh_traces():
    """``_head_fn_factory`` reads its switches while tracing, so each call must
    trace anew, and no trace made under a switch may outlive the test."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize('head', ['KRON', 'COLFORM'])
def test_opt_in_heads_match_plain_and_default(head, monkeypatch, fresh_traces):
    """The JAX kernel's opt-in heads (``DEEPQMC_TPU_ATTN_KRON``/``_COLFORM``,
    other contraction orders of the same function) in interpret mode against
    the port's plain version and the default head."""
    args = _inputs(5)
    monkeypatch.delenv('DEEPQMC_TPU_ATTN_KRON', raising=False)
    monkeypatch.delenv('DEEPQMC_TPU_ATTN_COLFORM', raising=False)
    default = _pallas_blocked(*map(jnp.asarray, args), interpret=True)
    monkeypatch.setenv(f'DEEPQMC_TPU_ATTN_{head}', '1')
    jax.clear_caches()
    got = _pallas_blocked(*map(jnp.asarray, args), interpret=True)
    plain = fl_attention.mha_core_fl_plain(*(torch.as_tensor(a) for a in args))
    _close(got, [p.numpy() for p in plain])
    _close(got, default)
