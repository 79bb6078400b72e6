"""The port's square-layout forward-Laplacian log-determinant against the JAX
package.

- The twins ``slogdet_fl_square`` and ``slogdet_fl_square_split`` (the CPU
  path: ``torch.linalg`` for the primal, the plain traces) against JAX
  ``slogdet_fl`` / ``slogdet_fl_split`` (vmapped) and the Pallas kernels
  ``_pallas_blocked`` / ``_pallas_blocked_split`` in interpret mode, on the
  same seeded inputs in JAX's batch-major layout ``[B, K, D, n, n]``, at
  float64.  Relative tolerance 1e-10: the same algebra with LU-based inverses
  on both sides, separated by float64 rounding only.
- ``fwdlap.slogdet``, ``slogdet_rows`` and ``slogdet_flat`` under the port's
  forward Laplacian against JAX ``forward_laplacian`` of the same function
  built on ``deepqmc_tpu.ops.slogdet`` / ``slogdet_flat`` and against the
  port's nested-autograd oracle ``physics.loop_laplacian``.  Relative
  tolerance 1e-8: second derivatives through an inverse, as
  ``tests/test_fl_slogdet.py`` holds JAX's rule to its own oracle.
- The kernel wrappers' CPU path and their input checks.
- A float64 emulation of the tiled body of kernels 3 and 4 (and of kernel 2
  above its threshold) at n = 33, 42 and 64 against the plain versions,
  relative 1e-12: the same sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one intra-op thread per pytest worker)

from deepqmc_tpu.fwdlap import forward_laplacian as jax_forward_laplacian
from deepqmc_tpu.ops.fl_slogdet import (
    _pallas_blocked,
    _pallas_blocked_split,
    slogdet_fl,
    slogdet_fl_split,
)
from deepqmc_tpu.ops.slogdet import slogdet as jax_slogdet
from deepqmc_tpu.ops.slogdet import slogdet_flat as jax_slogdet_flat
from deepqmc_tpu_torch import fwdlap as fl
from deepqmc_tpu_torch.ops import fl_slogdet
from deepqmc_tpu_torch.physics import loop_laplacian
from test_torch_fl_slogdet import LAYOUTS, _fill_stage, _global, _row, _tile_col, _up4, _vec
from test_torch_fl_slogdet import _rows as _layout_rows

RTOL = 1e-10
FL_RTOL = 1e-8
# (D, n, K, nu): the whole Jacobian (nu None) and two row splits
CASES = {'whole': (3, 4, 7, None), 'split_2_4': (2, 6, 7, 2), 'split_3_3': (2, 6, 7, 3)}


def _inputs(batch, D, n, K, seed=0):
    rng = np.random.default_rng(seed)
    # well-conditioned determinants: identity plus noise
    a = np.eye(n) + 0.5 * rng.normal(size=(batch, D, n, n))
    ja = rng.normal(size=(batch, K, D, n, n))
    la = rng.normal(size=(batch, D, n, n))
    return a, ja, la


def _close(got, want, rtol=RTOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=rtol)


@pytest.mark.parametrize('reference', ['twin', 'interpret'])
@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('batch', [1, 5, 16])
def test_square_twins_match_jax(batch, case, reference):
    D, n, K, nu = CASES[case]
    a, ja, la = _inputs(batch, D, n, K, seed=batch)
    if nu is None:
        args = (a, ja, la)
        port = fl_slogdet.slogdet_fl_square
        jax_fn = jax.vmap(slogdet_fl) if reference == 'twin' else (
            lambda *t: _pallas_blocked(*t, interpret=True))
    else:
        args = (a, ja[..., :nu, :], ja[..., nu:, :], la)
        port = fl_slogdet.slogdet_fl_square_split
        jax_fn = jax.vmap(slogdet_fl_split) if reference == 'twin' else (
            lambda *t: _pallas_blocked_split(*t, interpret=True))
    want = jax_fn(*map(jnp.asarray, args))
    got = port(*(torch.as_tensor(np.ascontiguousarray(x)) for x in args))
    assert [tuple(g.shape) for g in got] == [(batch, D), (batch, D), (batch, K, D), (batch, D)]
    _close([g.numpy() for g in got], want)


# --- the forward-Laplacian rules -----------------------------------------------

M, D, N = 3, 2, 4  # electrons (K = 3M directions), determinants, matrix size
_rng = np.random.default_rng(7)
W1 = _rng.normal(size=(3 * M, D * N * N)) / (3 * M)
W2 = _rng.normal(size=(D * N * N,))


def _mats_port(x):
    """[B, M, 3] -> D * N * N entries per walker; nonlinear so that J and L are nontrivial."""
    xf = x.flatten(-2)
    return fl.tanh(xf @ torch.as_tensor(W1)) + (1 + (xf * xf).sum(-1, keepdim=True)) * (
        torch.as_tensor(W2))


def _mats_jax(x):
    return jnp.tanh(x @ W1) + (1 + (x * x).sum()) * W2


def _square(v):  # [..., D*N*N] -> [..., D, N, N]
    return v.unflatten(-1, (D, N, N)) if not isinstance(v, jax.Array) else v.reshape(D, N, N)


def _flat(v):  # [..., D*N*N] -> [..., N, D*N]
    return v.unflatten(-1, (N, D * N)) if not isinstance(v, jax.Array) else v.reshape(N, D * N)


def _rows(m, nu):
    return m[..., :nu, :], 2.0 * m[..., nu:, :]


def _port_rows_fn(nu):
    return lambda x: fl.slogdet_rows(*_rows(_square(_mats_port(x)), nu))[1].sum(-1)


def _jax_rows_fn(nu):
    return lambda x: jax_slogdet(jnp.concatenate(_rows(_square(_mats_jax(x)), nu), -2))[1].sum()


# name: (port function of [B, M, 3], JAX function of one walker's [3M])
FUNCTIONS = {
    'slogdet': (lambda x: fl.slogdet(_square(_mats_port(x)))[1].sum(-1),
                lambda x: jax_slogdet(_square(_mats_jax(x)))[1].sum()),
    'slogdet_one_det': (lambda x: fl.slogdet(_square(_mats_port(x))[..., 1, :, :])[1],
                        lambda x: jax_slogdet(_square(_mats_jax(x))[1])[1]),
    'slogdet_of_cat': (lambda x: fl.slogdet(fl.cat(_rows(_square(_mats_port(x)), 2), -2))[1]
                       .sum(-1), _jax_rows_fn(2)),
    'slogdet_rows_2_2': (_port_rows_fn(2), _jax_rows_fn(2)),
    'slogdet_rows_3_1': (_port_rows_fn(3), _jax_rows_fn(3)),
    'slogdet_rows_4_0': (_port_rows_fn(4), _jax_rows_fn(4)),
    'slogdet_flat': (lambda x: fl.slogdet_flat(_flat(_mats_port(x)), D)[1].sum(-1),
                     lambda x: jax_slogdet_flat(_flat(_mats_jax(x)), D)[1].sum()),
    'slogdet_flat_rows': (lambda x: fl.slogdet_flat_rows(*_rows(_flat(_mats_port(x)), 2), D)[1]
                          .sum(-1),
                          lambda x: jax_slogdet_flat(
                              jnp.concatenate(_rows(_flat(_mats_jax(x)), 2), -2), D)[1].sum()),
}


@pytest.fixture(scope='module')
def walkers():
    return np.random.default_rng(8).normal(size=(3, M, 3))


@pytest.mark.parametrize('name', sorted(FUNCTIONS))
def test_forward_laplacian_matches_jax_and_oracle(name, walkers):
    port_f, jax_f = FUNCTIONS[name]
    r = torch.as_tensor(walkers)
    with torch.inference_mode():
        lap, grad = fl.forward_laplacian(port_f)(r)
        value = port_f(r)
    for b, x in enumerate(walkers.reshape(len(walkers), -1)):
        lap_j, grad_j = jax_forward_laplacian(jax_f)(jnp.asarray(x))
        np.testing.assert_allclose(grad[b].numpy(), np.asarray(grad_j), rtol=FL_RTOL)
        np.testing.assert_allclose(lap[b].item(), float(lap_j), rtol=FL_RTOL)
        np.testing.assert_allclose(value[b].item(), float(jax_f(jnp.asarray(x))), rtol=RTOL)
    lap_o, grad_o = loop_laplacian(port_f)(r)
    np.testing.assert_allclose(grad.numpy(), grad_o.detach().numpy(), rtol=FL_RTOL)
    np.testing.assert_allclose(lap.numpy(), lap_o.detach().numpy(), rtol=FL_RTOL)


def test_rules_take_the_kernels_in_their_layouts(monkeypatch):
    """Each rule hands its kernel-level function the layout that kernel reads:
    the whole square Jacobian, the square row blocks in place, the flat rows
    split at ceil(n/2)."""
    seen = []
    for name in ('square_traces', 'square_split_traces', 'slogdet_traces'):
        plain = getattr(fl_slogdet, f'{name}_plain')
        check = {'square_traces': fl_slogdet.validate_square,
                 'square_split_traces': fl_slogdet.validate_square_split,
                 'slogdet_traces': fl_slogdet.validate}[name]

        def wrapper(*args, name=name, plain=plain, check=check):
            check(*(a.float() for a in args))
            seen.append((name, *(tuple(a.shape) for a in args[1:])))
            return plain(*args)

        monkeypatch.setattr(fl_slogdet, name, wrapper)
    x = fl.FL.seed(torch.as_tensor(np.random.default_rng(9).normal(size=(2, M, 3))))
    K = 3 * M
    with torch.inference_mode():
        m = _square(_mats_port(x))
        fl.slogdet(m)
        fl.slogdet_rows(m[..., :3, :], m[..., 3:, :])
        fl.slogdet_flat(_flat(_mats_port(x)), D)
    assert seen == [
        ('square_traces', (2, K, D, N, N), (2, D, N, N)),
        ('square_split_traces', (2, K, D, 3, N), (2, K, D, 1, N), (2, D, N, N)),
        ('slogdet_traces', (2, K, 2, D * N), (2, K, 2, D * N)),
    ]


# --- the kernel wrappers ---------------------------------------------------------


def _kernel_operands(kind, B=2, K=3, D=2, nu=2, nd=2, seed=0, dtype=torch.float32):
    """Operands of one kernel-level function: 'flat' (kernel 2), 'square'
    (kernel 3, n = nu + nd) or 'square_split' (kernel 4)."""
    n = nu + nd
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(np.eye(n) + 0.3 / n**0.5 * rng.normal(size=(B, D, n, n)))
    inv = torch.linalg.inv(a).to(dtype).contiguous()
    ja = torch.as_tensor(rng.normal(size=(B, K, D, n, n)), dtype=dtype)
    la = torch.as_tensor(rng.normal(size=(B, D, n, n)), dtype=dtype)

    def flat(j):  # [B, K, D, rows, n] -> [B, K, rows, D*n]
        return j.movedim(2, 3).flatten(-2).contiguous()

    if kind == 'flat':
        return inv, flat(ja[..., :nu, :]), flat(ja[..., nu:, :])
    if kind == 'square':
        return inv, ja, la
    return inv, ja[..., :nu, :].contiguous(), ja[..., nu:, :].contiguous(), la


KERNELS = {
    'flat': ('slogdet_traces', 'validate'),
    'square': ('square_traces', 'validate_square'),
    'square_split': ('square_split_traces', 'validate_square_split'),
}


@pytest.mark.parametrize('kind', sorted(KERNELS))
def test_wrapper_takes_plain_version_on_cpu(kind):
    fn = getattr(fl_slogdet, KERNELS[kind][0])
    plain = getattr(fl_slogdet, KERNELS[kind][0] + '_plain')
    args = _kernel_operands(kind, seed=1)
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before
    for g, w in zip(got, plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize('shape', ['n42', 'n64', 'nd0', 'n1'])
@pytest.mark.parametrize('kind', sorted(KERNELS))
def test_kernel_input_checks_accept(kind, shape):
    nu, nd = {'n42': (21, 21), 'n64': (32, 32), 'nd0': (3, 0), 'n1': (1, 0)}[shape]
    getattr(fl_slogdet, KERNELS[kind][1])(*_kernel_operands(kind, B=1, K=2, D=1, nu=nu, nd=nd))


@pytest.mark.parametrize('fault', ['n65', 'dtype', 'shape', 'layout'])
@pytest.mark.parametrize('kind', sorted(KERNELS))
def test_kernel_input_checks_reject(kind, fault):
    validate = getattr(fl_slogdet, KERNELS[kind][1])
    nu, nd = (33, 32) if fault == 'n65' else (2, 2)
    args = list(_kernel_operands(kind, B=1, K=2, D=2, nu=nu, nd=nd))
    if fault == 'dtype':
        args[-1] = args[-1].double()
    elif fault == 'shape':
        args[1] = args[1][..., :-1]
    elif fault == 'layout':
        args[1] = args[1].transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises((TypeError, ValueError)):
        validate(*args)


def test_plain_versions_match_explicit_products_at_n42():
    """At n = 42 (benzene) the three plain versions agree with a loop of
    explicit float64 products over (walker, direction, determinant)."""
    B, K, D, nu, nd = 1, 2, 2, 21, 21
    inv, ja, la = _kernel_operands('square', B, K, D, nu, nd, seed=2, dtype=torch.float64)
    _, ju_flat, jd_flat = _kernel_operands('flat', B, K, D, nu, nd, seed=2, dtype=torch.float64)
    jout_s, lout_s = fl_slogdet.square_traces_plain(inv, ja, la)
    jout_p, lout_p = fl_slogdet.square_split_traces_plain(
        inv, ja[..., :nu, :], ja[..., nu:, :], la)
    jout_f, trq_f = fl_slogdet.slogdet_traces_plain(inv, ju_flat, jd_flat)
    for b in range(B):
        for d in range(D):
            trq = 0.0
            for k in range(K):
                m = inv[b, d] @ ja[b, k, d]
                for jout in (jout_s, jout_p, jout_f):
                    torch.testing.assert_close(jout[b, k, d], torch.trace(m), rtol=RTOL, atol=0)
                trq = trq + torch.trace(m @ m)
            lout = torch.trace(inv[b, d] @ la[b, d]) - trq
            torch.testing.assert_close(trq_f[b, d], trq, rtol=RTOL, atol=0)
            for got in (lout_s, lout_p):
                torch.testing.assert_close(got[b, d], lout, rtol=RTOL, atol=RTOL)


# --- the tiled body's algebra ------------------------------------------------------


def _tiled_traces(layout, inv, ja, la, nu):
    """A float64 emulation of the tiled body: A^-1 transposed and padded to np
    with zero columns, J_k's rows read from the stage the record's copies fill
    (NaN where no copy writes), each thread's 4 x 4 tile of m = A^-1 J_k over
    rows 4 ti .. 4 ti + 3 and its columns ``tile_col``, tr(m_k) from the
    diagonal, sum_k tr(m_k^2) from each tile and the transposed tile, masked
    to the n x n block; (jout [B, K, D], out [B, D])."""
    B, K, D, n, _ = ja.shape
    np_, nt, vec = _up4(n), _up4(n) // 4, _vec(layout, n)
    rb = fl_slogdet.row_blocks(layout, D, nu, n - nu, 1)
    up, dn = _global(layout, ja, nu)
    jout, out = np.zeros((B, K, D)), np.zeros((B, D))
    for b in range(B):
        for d in range(D):
            at = np.zeros((n, np_))
            at[:, :n] = inv[b, d].T
            part = sum(at.reshape(-1)[(e // n) * np_ + e % n] * la[b, d].reshape(-1)[e]
                       for e in range(n * n)) if la is not None else 0.0
            q = 0.0
            for k in range(K):
                stage, shifts = _fill_stage(layout, rb, up, dn, b, k, d, K, 1, nu, n - nu)
                J = np.stack([_row(rb, stage, 0, c, nu, np_, shifts) for c in range(n)])  # [n, np]
                with np.errstate(invalid='ignore'):
                    m = at.T @ J  # columns beyond n hold NaN: the kernel masks them
                for ti in range(nt):
                    rows = np.arange(4 * ti, 4 * ti + 4)
                    for tj in range(nt):
                        cols = np.array([_tile_col(vec, tj, c, nt) for c in range(4)])
                        pair = m[np.ix_(rows, cols)] * m[np.ix_(cols, rows)].T
                        q += np.where(np.outer(rows < n, cols < n), pair, 0.0).sum()
                jout[b, k, d] = np.trace(m[:n, :n])
            out[b, d] = part - q if la is not None else q
    return jout, out


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
@pytest.mark.parametrize('n', [33, 42, 64])
def test_tiled_emulation_matches_plain(layout, n):
    """The tiled body's algebra at f64 against the plain versions, relative 1e-12."""
    lay = LAYOUTS[layout]
    nu = _layout_rows(lay, n)[0]
    rng = np.random.default_rng(n)
    B, K, D = 1, 2, 2
    a = np.eye(n) + 0.3 / n**0.5 * rng.normal(size=(B, D, n, n))
    inv = np.linalg.inv(a)
    ja = rng.normal(size=(B, K, D, n, n))
    la = rng.normal(size=(B, D, n, n))
    t = torch.as_tensor
    if lay == fl_slogdet.FLAT:
        got = _tiled_traces(lay, inv, ja, None, nu)
        ju, jd = (t(np.ascontiguousarray(np.swapaxes(j, 2, 3)).reshape(B, K, -1, D * n))
                  for j in (ja[..., :nu, :], ja[..., nu:, :]))
        want = fl_slogdet.slogdet_traces_plain(t(inv), ju, jd)
    else:
        got = _tiled_traces(lay, inv, ja, la, nu)
        want = fl_slogdet.square_traces_plain(t(inv), t(ja), t(la))
    for g, w in zip(got, want):
        scale = max(1.0, np.abs(w.numpy()).max())
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-12, atol=1e-12 * scale)
