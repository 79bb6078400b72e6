"""Kernels 1-4's plain versions with bf16-stored Jacobians against the JAX package.

The JAX package's Pallas kernels take bf16 Jacobian operands and upcast them
after the load (``DEEPQMC_TPU_JAC_DTYPE=bf16``); kernel 1 also has a ``low``
mode (``DEEPQMC_TPU_JAC_MATMUL=bf16`` at float32) that rounds the operands of
its Jacobian contractions to bf16.  The port's plain versions (the CPU path of
the wrappers, and the CUDA kernels' oracle on the card) are held to the JAX
twins and to the Pallas kernels in interpret mode, both sides fed the same
bf16 values, at float32.  Relative tolerance 1e-5: the same values in another
summation order, float32 rounding apart.  J_t, which the port writes at the
Jacobians' dtype (bf16) where JAX writes float32 and stores it outside, is
held within one bf16 spacing (2^-8 of it) of JAX's value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one intra-op thread per pytest worker)

from deepqmc_tpu.ops.fl_attention import _pallas_blocked as jax_attention_kernel
from deepqmc_tpu.ops.fl_slogdet import (
    _pallas_blocked,
    _pallas_blocked_flat_split,
    _pallas_blocked_split,
    slogdet_fl,
    slogdet_fl_flat_split,
    slogdet_fl_split,
)
from deepqmc_tpu_torch.ops import fl_attention, fl_slogdet

RTOL = 1e-5
BF16_SPACING = 2.0**-8


def _bf16(x):
    """``x`` rounded to bf16: (the torch tensor, the same values for JAX)."""
    t = torch.as_tensor(np.asarray(x, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=rtol)


def _within_bf16_spacing(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= BF16_SPACING * np.abs(want) + RTOL)


def _attention_inputs(seed, b=3, n=4, h=2, dh=8, k=12):
    rng = np.random.default_rng(seed)
    prim = [rng.normal(size=(b, n, h, dh)).astype(np.float32) for _ in range(3)]
    jacs = [_bf16(rng.normal(size=(b, k, n, h, dh))) for _ in range(3)]
    laps = [rng.normal(size=(b, n, h, dh)).astype(np.float32) for _ in range(3)]
    return prim, jacs, laps


@pytest.mark.parametrize('low', [False, True], ids=['bf16', 'bf16_low'])
def test_attention_plain_matches_interpret_mode_kernel(monkeypatch, low):
    """Kernel 1 with bf16 J, with and without its low mode (read by the JAX
    kernel from DEEPQMC_TPU_JAC_MATMUL when it traces)."""
    monkeypatch.setenv('DEEPQMC_TPU_JAC_MATMUL', 'bf16' if low else 'f32')
    jax_attention_kernel.clear_cache()
    prim, jacs, laps = _attention_inputs(seed=int(low))
    want = jax_attention_kernel(*map(jnp.asarray, prim), *(j for _, j in jacs),
                                *map(jnp.asarray, laps), interpret=True)
    got = fl_attention.mha_core_fl_plain(*map(torch.as_tensor, prim), *(t for t, _ in jacs),
                                         *map(torch.as_tensor, laps), low=low)
    assert got[1].dtype == torch.bfloat16 and want[1].dtype == jnp.float32
    _close(got[0], want[0])
    _within_bf16_spacing(got[1].float(), want[1])
    _close(got[2], want[2])
    jax_attention_kernel.clear_cache()


def test_attention_low_mode_rounds_only_jacobian_contractions():
    """With float32 J, the low mode moves J_t and L_t by bf16 roundings but
    leaves the primal t; without it the plain version is the float32 one."""
    prim, jacs, laps = _attention_inputs(seed=2)
    args = [*map(torch.as_tensor, prim), *(t.float() for t, _ in jacs),
            *map(torch.as_tensor, laps)]
    full = fl_attention.mha_core_fl_plain(*args)
    low = fl_attention.mha_core_fl_plain(*args, low=True)
    torch.testing.assert_close(low[0], full[0], rtol=0, atol=0)
    assert not torch.equal(low[1], full[1])
    torch.testing.assert_close(low[1], full[1], rtol=0, atol=5e-2)
    wrapped = fl_attention.mha_core_fl(*args, low=True)  # a CPU tensor: the plain version
    for w, g in zip(wrapped, low):
        assert torch.equal(w, g)


def _square_inputs(seed, b=4, d=2, n=6, k=7):
    rng = np.random.default_rng(seed)
    a = (np.eye(n) + 0.5 * rng.normal(size=(b, d, n, n))).astype(np.float32)
    ja = rng.normal(size=(b, k, d, n, n)).astype(np.float32)
    la = rng.normal(size=(b, d, n, n)).astype(np.float32)
    return a, ja, la


@pytest.mark.parametrize('reference', ['twin', 'interpret'])
@pytest.mark.parametrize('layout', ['square', 'square_split', 'flat_split'])
def test_slogdet_plain_matches_jax_with_bf16_jacobian(layout, reference):
    """Kernels 3, 4 and 2: the traces of a bf16-stored Jacobian, the inverse,
    the Laplacian and the outputs in float32."""
    a, ja, la = _square_inputs(seed=len(layout))
    D, n = a.shape[1], a.shape[-1]
    nu = n // 2
    if layout == 'square':
        jt, jj = _bf16(ja)
        port = fl_slogdet.slogdet_fl_square(torch.as_tensor(a), jt, torch.as_tensor(la))
        jax_args = (jnp.asarray(a), jj, jnp.asarray(la))
        fn = jax.vmap(slogdet_fl) if reference == 'twin' else (
            lambda *t: _pallas_blocked(*t, interpret=True))
    elif layout == 'square_split':
        (ut, uj), (dt, dj) = _bf16(ja[..., :nu, :]), _bf16(ja[..., nu:, :])
        port = fl_slogdet.slogdet_fl_square_split(torch.as_tensor(a), ut, dt,
                                                  torch.as_tensor(la))
        jax_args = (jnp.asarray(a), uj, dj, jnp.asarray(la))
        fn = jax.vmap(slogdet_fl_split) if reference == 'twin' else (
            lambda *t: _pallas_blocked_split(*t, interpret=True))
    else:  # the ansatz's det-major flat rows [B, n, D n], J [B, K, rows, D n]
        def flat(x):
            return np.ascontiguousarray(np.moveaxis(x, -3, -2).reshape(*x.shape[:-3], n, D * n))

        a_f, la_f = flat(a), flat(la)
        (ut, uj), (dt, dj) = _bf16(flat(ja)[..., :nu, :]), _bf16(flat(ja)[..., nu:, :])
        port = fl_slogdet.slogdet_fl_flat_split(torch.as_tensor(a_f), ut, dt,
                                                torch.as_tensor(la_f), D)
        jax_args = (jnp.asarray(a_f), uj, dj, jnp.asarray(la_f))
        fn = jax.vmap(lambda *t: slogdet_fl_flat_split(*t, D)) if reference == 'twin' else (
            lambda *t: _pallas_blocked_flat_split(*t, D, interpret=True))
    want = fn(*jax_args)
    assert port[2].dtype == torch.float32 and port[3].dtype == torch.float32
    for g, w in zip(port, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize('kernel', ['traces', 'square', 'square_split'])
def test_slogdet_wrappers_take_bf16_jacobians_on_cpu(kernel):
    """On a CPU tensor each wrapper runs its plain version on bf16 Jacobians,
    upcast, as the float32 values it stands for."""
    rng = np.random.default_rng(5)
    B, K, D, n = 3, 5, 2, 4
    inv = torch.as_tensor(np.linalg.inv(np.eye(n) + 0.3 * rng.normal(size=(B, D, n, n))),
                          dtype=torch.float32)
    la = torch.as_tensor(rng.normal(size=(B, D, n, n)), dtype=torch.float32)
    if kernel == 'traces':
        j = [torch.as_tensor(rng.normal(size=(B, K, r, D * n)), dtype=torch.bfloat16)
             for r in (2, 2)]
        got, want = (fl_slogdet.slogdet_traces(inv, *j),
                     fl_slogdet.slogdet_traces_plain(inv, *(x.float() for x in j)))
    elif kernel == 'square':
        j = torch.as_tensor(rng.normal(size=(B, K, D, n, n)), dtype=torch.bfloat16)
        got, want = (fl_slogdet.square_traces(inv, j, la),
                     fl_slogdet.square_traces_plain(inv, j.float(), la))
    else:
        j = [torch.as_tensor(rng.normal(size=(B, K, D, r, n)), dtype=torch.bfloat16)
             for r in (1, 3)]
        got, want = (fl_slogdet.square_split_traces(inv, *j, la),
                     fl_slogdet.square_split_traces_plain(inv, *(x.float() for x in j), la))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize('esize', [4, 2], ids=['f32', 'bf16'])
def test_row_blocks_of_a_bf16_jacobian(esize):
    """The layout record counts elements of the Jacobian: a bf16 stage row is
    padded to 8 of them (16 bytes), a 16-byte copy is 8, one bf16 a copy where
    nothing wider divides the runs, and a square layout's runs go at their
    shift where the (walker, direction) strides are whole 16-byte chunks."""
    V = 16 // esize
    flat = fl_slogdet.row_blocks(fl_slogdet.FLAT, 16, 5, 5, 16, esize=esize)
    assert flat.s_row % V == 0 and flat.vw == V and flat.runs == 1
    odd = fl_slogdet.row_blocks(fl_slogdet.FLAT, 3, 3, 2, 3, esize=esize)
    assert odd.vw == 1
    shifted = fl_slogdet.row_blocks(fl_slogdet.SQUARE, 8, 5, 0, 1, esize=esize)
    assert shifted.up_bk % V == 0 and shifted.shift == 1 and shifted.vw == 1
    assert shifted.s_dn % V == 0 and shifted.stage >= 25 + V - 1
    assert fl_slogdet.row_blocks(fl_slogdet.FLAT, 16, 5, 5, 16, align=2, esize=2).vw == 1


def test_attention_validate_takes_bf16_jacobians_only_whole():
    prim, jacs, laps = _attention_inputs(seed=4)
    args = [*map(torch.as_tensor, prim), *(t for t, _ in jacs), *map(torch.as_tensor, laps)]
    fl_attention.validate(*args)  # all three bf16: taken
    mixed = list(args)
    mixed[4] = mixed[4].float()
    with pytest.raises(TypeError, match='Jk'):
        fl_attention.validate(*mixed)
    narrow = [x[..., :4].contiguous() for x in args]  # dh = 4: no 16-byte bf16 copies
    with pytest.raises(ValueError, match='dh'):
        fl_attention.validate(*narrow)

