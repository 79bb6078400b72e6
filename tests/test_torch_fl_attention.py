"""The port's forward-Laplacian attention core against the JAX package.

The plain version (the CPU path of ``deepqmc_tpu_torch.ops.mha_core_fl``) is
held to JAX ``mha_core_fl`` and to the Pallas kernel ``_pallas_blocked`` in
interpret mode, on the same seeded inputs, at float64.  Relative tolerance
1e-10: the same algebra in another summation order (einsum vs dot_general),
so only float64 rounding separates them.

The CUDA kernel (``csrc/fl_attention.cu``) runs the softmax's forward
Laplacian in one pass over the directions, with sums over k in place of the
[K, n, n] softmax Jacobian.  ``_one_pass`` repeats that algebra in PyTorch,
direction chunk by chunk, and is held to the plain version and to JAX at
float64 within 1e-12 relative (relative to max(1, max |reference|)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one intra-op thread per pytest worker)

from deepqmc_tpu.ops.fl_attention import _pallas_blocked
from deepqmc_tpu.ops.fl_attention import mha_core_fl as jax_mha_core_fl
from deepqmc_tpu_torch.ops import fl_attention

B, N, H, DH, K = 3, 4, 2, 8, 12
RTOL = 1e-10


def _inputs(seed=0, b=B, n=N, h=H, dh=DH, k=K):
    rng = np.random.default_rng(seed)
    prim = [rng.normal(size=(b, n, h, dh)) for _ in range(3)]
    jacs = [rng.normal(size=(b, k, n, h, dh)) for _ in range(3)]
    laps = [rng.normal(size=(b, n, h, dh)) for _ in range(3)]
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


@pytest.mark.parametrize('mode', ['twin', 'interpret'])
def test_plain_matches_jax_at_42_tokens(mode):
    """Benzene's electron count, beyond the old kernel's 32, through the JAX
    twin and the Pallas kernel in interpret mode."""
    args = _inputs(6, b=2, n=42, h=2, dh=8, k=5)
    jargs = list(map(jnp.asarray, args))
    if mode == 'twin':
        want = jax.vmap(jax_mha_core_fl)(*jargs)
    else:
        want = _pallas_blocked(*jargs, interpret=True)
    got = fl_attention.mha_core_fl_plain(*(torch.as_tensor(a) for a in args))
    _close([g.numpy() for g in got], want)


def _one_pass(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv, chunk):
    """The kernel's algebra: the directions in chunks of ``chunk``, each adding
    its share of W = sum_k (2 Jq_k Jk_k^T / sqrt(dh) + Jz_k^2), P = sum_k Jz_k
    g_k, G = sum_k g_k^2 and Sav = sum_k Ja_k Jv_k, with Ja_k = a (Jz_k - g_k)
    formed from a and g_k and written out at once; La and Lt at the end."""
    scale = 1.0 / q.shape[-1] ** 0.5
    a = torch.softmax(torch.einsum('bihd,bjhd->bhij', q, k) * scale, dim=-1)
    W = torch.zeros_like(a)
    P = torch.zeros_like(a)
    G = torch.zeros_like(a[..., 0])
    Sav = torch.zeros_like(v)
    Jt = torch.empty_like(Jq)
    for k0 in range(0, Jq.shape[1], chunk):
        ks = slice(k0, k0 + chunk)
        Jz = (torch.einsum('bkihd,bjhd->bkhij', Jq[:, ks], k)
              + torch.einsum('bihd,bkjhd->bkhij', q, Jk[:, ks])) * scale
        cross = torch.einsum('bkihd,bkjhd->bkhij', Jq[:, ks], Jk[:, ks])
        g = (a.unsqueeze(1) * Jz).sum(-1)  # [B, kc, H, n]
        W += (2 * scale * cross + Jz * Jz).sum(1)
        P += (Jz * g.unsqueeze(-1)).sum(1)
        G += (g * g).sum(1)
        Ja = a.unsqueeze(1) * (Jz - g.unsqueeze(-1))
        Jt[:, ks] = (torch.einsum('bkhij,bjhd->bkihd', Ja, v)
                     + torch.einsum('bhij,bkjhd->bkihd', a, Jv[:, ks]))
        Sav += torch.einsum('bkhij,bkjhd->bihd', Ja, Jv[:, ks])
    w = (torch.einsum('bihd,bjhd->bhij', Lq, k) + torch.einsum('bihd,bjhd->bhij', q, Lk)) * scale + W
    m = (a * w).sum(-1, keepdim=True)
    La = a * (w - m - 2 * P + 2 * G.unsqueeze(-1))
    t = torch.einsum('bhij,bjhd->bihd', a, v)
    Lt = (torch.einsum('bhij,bjhd->bihd', La, v) + torch.einsum('bhij,bjhd->bihd', a, Lv)
          + 2 * Sav)
    return t, Jt, Lt


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize('n', [10, 42, 64])
def test_one_pass_algebra_matches_plain_and_jax(n):
    """K = 7 directions in chunks of 3 (the last chunk short)."""
    args = _inputs(7, b=2, n=n, h=2, dh=8, k=7)
    targs = [torch.as_tensor(a) for a in args]
    got = _one_pass(*targs, chunk=3)
    plain = fl_attention.mha_core_fl_plain(*targs)
    twin = jax.vmap(jax_mha_core_fl)(*map(jnp.asarray, args))
    for g, p, j in zip(got, plain, twin):
        assert _rel_err(g.numpy(), p.numpy()) <= 1e-12
        assert _rel_err(g.numpy(), j) <= 1e-12


@pytest.mark.parametrize('n', [33, 42, 64, 65])
def test_validate_takes_up_to_64_tokens(n):
    args = [torch.as_tensor(a, dtype=torch.float32)
            for a in _inputs(8, b=1, n=n, h=1, dh=4, k=2)]
    if n <= fl_attention.MAX_N:
        fl_attention.validate(*args)
    else:
        with pytest.raises(ValueError, match='n <= 64'):
            fl_attention.validate(*args)
