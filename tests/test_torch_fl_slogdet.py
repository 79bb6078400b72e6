"""The port's forward-Laplacian flat log-determinant against the JAX package.

``slogdet_fl_flat_split`` (the CPU path: ``torch.linalg`` for the primal and
the plain traces ``slogdet_traces_plain``) is held to JAX
``slogdet_fl_flat_split`` and to the Pallas kernel
``_pallas_blocked_flat_split`` in interpret mode, on the same seeded inputs,
at float64.  Relative tolerance 1e-10: the same algebra, with LU-based
inverses on both sides, separated by float64 rounding only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepqmc_tpu.ops.fl_slogdet import _pallas_blocked_flat_split
from deepqmc_tpu.ops.fl_slogdet import slogdet_fl_flat_split as jax_flat_split
from deepqmc_tpu_torch.ops import fl_slogdet

B, NU, ND, D, K = 3, 2, 2, 3, 12
N = NU + ND
RTOL = 1e-10


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    # well-conditioned determinants: identity blocks plus noise
    a = np.tile(np.eye(N), (1, D))[None] + 0.5 * rng.normal(size=(B, N, D * N))
    ju = rng.normal(size=(B, K, NU, D * N))
    jd = rng.normal(size=(B, K, ND, D * N))
    la = rng.normal(size=(B, N, D * N))
    return a, ju, jd, la


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize('seed', [0, 1])
def test_flat_split_matches_jax_twin(seed):
    args = _inputs(seed)
    want = jax.vmap(lambda *t: jax_flat_split(*t, D))(*map(jnp.asarray, args))
    got = fl_slogdet.slogdet_fl_flat_split(*(torch.as_tensor(x) for x in args), D)
    _close([g.numpy() for g in got], want)


def test_flat_split_matches_interpret_mode_kernel():
    args = _inputs(2)
    want = _pallas_blocked_flat_split(*map(jnp.asarray, args), D, interpret=True)
    got = fl_slogdet.slogdet_fl_flat_split(*(torch.as_tensor(x) for x in args), D)
    _close([g.numpy() for g in got], want)


def test_plain_traces_match_explicit_products():
    """jout and trq of the plain version against a loop over (walker, k, det)."""
    a, ju, jd, _ = (torch.as_tensor(x) for x in _inputs(3))
    inv = torch.linalg.inv(a.unflatten(-1, (D, N)).movedim(-2, -3))
    jout, trq = fl_slogdet.slogdet_traces_plain(inv, ju, jd)
    j = torch.cat([ju, jd], dim=2)
    for b in range(B):
        for d in range(D):
            q = 0.0
            for k in range(K):
                m = inv[b, d] @ j[b, k, :, d * N:(d + 1) * N]
                assert torch.allclose(jout[b, k, d], torch.trace(m), rtol=RTOL)
                q = q + torch.trace(m @ m)
            assert torch.allclose(trq[b, d], q, rtol=RTOL)


def test_wrapper_takes_plain_version_on_cpu():
    a, ju, jd, _ = (torch.as_tensor(x) for x in _inputs(4))
    inv = torch.linalg.inv(a.unflatten(-1, (D, N)).movedim(-2, -3))
    before = fl_slogdet.slogdet_traces.launches
    got = fl_slogdet.slogdet_traces(inv, ju, jd)
    want = fl_slogdet.slogdet_traces_plain(inv, ju, jd)
    assert fl_slogdet.slogdet_traces.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('fault', ['dtype', 'shape', 'layout'])
def test_kernel_input_checks_reject(fault):
    a, ju, jd, _ = (torch.as_tensor(x, dtype=torch.float32) for x in _inputs(5))
    inv = torch.linalg.inv(a.unflatten(-1, (D, N)).movedim(-2, -3)).contiguous()
    fl_slogdet.validate(inv, ju, jd)
    if fault == 'dtype':
        ju = ju.double()
    elif fault == 'shape':
        jd = jd[..., :-1]
    else:
        inv = inv.transpose(-1, -2)
    with pytest.raises((TypeError, ValueError)):
        fl_slogdet.validate(inv, ju, jd)


def _flat_smem_bytes(n, G, S):
    """Bytes of the flat kernel's shared-memory plan (``flat_layout`` of
    ``csrc/fl_slogdet.cu``): S stages of n rows by G n columns (rounded up to
    4), A^-1 transposed (above 16 electrons), the rows of m with one column of
    padding, and an 8-byte mbarrier a stage."""
    gn = G * n
    floats = S * n * ((gn + 3) // 4 * 4) + (n * gn if n > 16 else 0) + gn * (n + 1)
    return 4 * ((floats + 1) // 2 * 2 + 2 * S)


@pytest.mark.parametrize('case, B, D, n, want', [
    ('H2O, all determinants a block', 2048, 16, 10, 16),
    ('benzene, 2 of 42 rows a block', 256, 16, 42, 2),
    ('n = 48, one a block to fill the card', 64, 4, 48, 1),
    ('few walkers, one a block', 5, 3, 7, 1),
])
def test_flat_plan_groups(case, B, D, n, want):
    """Determinants a block of the flat kernel on an H100 (132 SMs, 227 KB a block)."""
    assert fl_slogdet.flat_plan(B, D, n, 132, 232448, _flat_smem_bytes) == want


def test_flat_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match='shared memory'):
        fl_slogdet.flat_plan(64, 4, 48, 132, 30_000, _flat_smem_bytes)
