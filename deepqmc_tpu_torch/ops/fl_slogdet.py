"""Forward-Laplacian log-determinant (counterpart of
``deepqmc_tpu/ops/fl_slogdet.py``).

For each walker and determinant d, with ``A_d`` its Slater matrix and
``J_{k,d}``, ``L_d`` its Jacobian and Laplacian:

    J_k log|det A_d| = tr(A_d^-1 J_{k,d})
    L log|det A_d|   = tr(A_d^-1 L_d) - sum_k tr((A_d^-1 J_{k,d})^2)

The primal sign, log|det| and inverse use ``torch.linalg`` (the JAX package
also keeps them outside its kernels).  The traces come in three layouts of the
Jacobian, each with a kernel-level function that runs its plain version on a
CPU tensor and its hand-written kernel (``csrc/fl_slogdet.cu``) on a CUDA
tensor, or raises:

- flat row blocks (``ju`` ``[B, K, nu, D*n]``, ``jd`` ``[B, K, nd, D*n]``, the
  ansatz's det-major columns): :func:`slogdet_traces`, under
  :func:`slogdet_fl_flat_split`;
- square, whole (``ja`` ``[B, K, D, n, n]``): :func:`square_traces`, under
  :func:`slogdet_fl_square`;
- square row blocks (``ju`` ``[B, K, D, nu, n]``, ``jd`` ``[B, K, D, nd, n]``):
  :func:`square_split_traces`, under :func:`slogdet_fl_square_split`.

The square kernels return the Laplacian with its linear term tr(A_d^-1 L_d),
as the TPU kernels do; the flat one returns sum_k tr(m_k^2) only.
"""

import functools

import torch

from . import _cuda
from .slogdet import unflatten_dets

__all__ = [
    'slogdet_fl_flat_split',
    'slogdet_fl_square',
    'slogdet_fl_square_split',
    'slogdet_traces',
    'slogdet_traces_plain',
    'square_split_traces',
    'square_split_traces_plain',
    'square_traces',
    'square_traces_plain',
]

MAX_N = 64  # electrons per determinant the kernels take (a register row of m)


# --- plain versions -----------------------------------------------------------


def _traces(inv, j):
    """(tr(A^-1 J_k) [B, K, D], sum_k tr((A^-1 J_k)^2) [B, D]) on the square layout."""
    jout = torch.einsum('bdij,bkdji->bkd', inv, j)
    m = torch.einsum('bdij,bkdjl->bkdil', inv, j)
    trq = torch.einsum('bkdij,bkdji->bd', m, m)
    return jout, trq


def slogdet_traces_plain(inv, ju, jd):
    """(jout [B, K, D], trq [B, D]) from the inverse [B, D, n, n] and flat row blocks."""
    j = torch.cat([ju, jd], dim=-2)
    return _traces(inv, j.unflatten(-1, (inv.shape[1], -1)).movedim(-2, -3))


def square_traces_plain(inv, ja, la):
    """(jout [B, K, D], lout [B, D]) from the inverse, ja [B, K, D, n, n] and la [B, D, n, n]."""
    jout, trq = _traces(inv, ja)
    return jout, torch.einsum('bdij,bdji->bd', inv, la) - trq


def square_split_traces_plain(inv, ju, jd, la):
    """:func:`square_traces_plain` with the Jacobian in row blocks
    ju [B, K, D, nu, n] and jd [B, K, D, nd, n]."""
    return square_traces_plain(inv, torch.cat([ju, jd], dim=-2), la)


# --- input checks -------------------------------------------------------------


def _check(inv, *named):
    """Raise unless ``inv`` is [B, D, n, n] with n <= MAX_N and every operand is
    float32 on its device, contiguous and of its shape."""
    B, D, n, _ = inv.shape
    if n > MAX_N:
        raise ValueError(f'fl_slogdet: n={n} > {MAX_N} electrons per determinant')
    for name, x, shape in (('inv', inv, (B, D, n, n)), *named):
        if x.device != inv.device or x.dtype != torch.float32:
            raise TypeError(f'fl_slogdet: {name} must be float32 on {inv.device}')
        if tuple(x.shape) != shape:
            raise ValueError(f'fl_slogdet: {name} has shape {tuple(x.shape)}, want {shape}')
        if not x.is_contiguous():
            raise ValueError(f'fl_slogdet: {name} must be contiguous')


def validate(inv, ju, jd):
    """Operands of the flat kernel: inv [B, D, n, n], ju [B, K, nu, D*n], jd [B, K, nd, D*n]."""
    B, D, n, _ = inv.shape
    K, nu, nd = ju.shape[1], ju.shape[2], jd.shape[2]
    _check(inv, ('ju', ju, (B, K, nu, D * n)), ('jd', jd, (B, K, nd, D * n)))


def validate_square(inv, ja, la):
    """Operands of the square kernel: inv and la [B, D, n, n], ja [B, K, D, n, n]."""
    B, D, n, _ = inv.shape
    _check(inv, ('ja', ja, (B, ja.shape[1], D, n, n)), ('la', la, (B, D, n, n)))


def validate_square_split(inv, ju, jd, la):
    """Operands of the square split kernel: inv and la [B, D, n, n],
    ju [B, K, D, nu, n], jd [B, K, D, nd, n]."""
    B, D, n, _ = inv.shape
    K, nu, nd = ju.shape[1], ju.shape[3], jd.shape[3]
    _check(inv, ('ju', ju, (B, K, D, nu, n)), ('jd', jd, (B, K, D, nd, n)),
           ('la', la, (B, D, n, n)))


# --- kernels ------------------------------------------------------------------


def _launch(counter, entry, smem_entry, inv, operands, K, sizes):
    """Launch ``entry`` of the library on ``inv`` and ``operands``; (jout, out)."""
    B, D, n, _ = inv.shape
    lib, limit = _cuda.library(), _cuda.smem_limit()
    if getattr(lib, smem_entry)(n) > limit:
        raise ValueError(f'{entry}: n={n} exceeds the {limit} B of shared memory a block can use')
    jout = torch.empty((B, K, D), dtype=inv.dtype, device=inv.device)
    out = torch.empty((B, D), dtype=inv.dtype, device=inv.device)
    with torch.cuda.device(inv.device):
        code = getattr(lib, entry)(
            inv.data_ptr(), *(x.data_ptr() for x in operands), jout.data_ptr(), out.data_ptr(),
            B, D, K, *sizes, _cuda.stream(),
        )
    _cuda.check(code, entry)
    counter.launches += 1
    return jout, out


FLAT_MAX_THREADS = 256  # a flat-kernel block: at most one thread per (determinant, row)
# Directions in the flat kernel's copy ring: two on their way while one is in
# use.  More stages cost blocks per SM, which the kernel needs more (PERF.md).
FLAT_STAGES = 3


def flat_plan(B, D, n, sms, limit, smem_bytes):
    """G, the determinants a block of the flat kernel takes.

    The largest divisor of D with G n <= FLAT_MAX_THREADS that gives each of
    the ``sms`` SMs two blocks of the grid and fits two blocks in an SM's
    ``limit`` bytes by ``smem_bytes(n, G, FLAT_STAGES)``: the kernel waits on
    its loads and needs blocks in flight more than determinants a block.
    Else 1, if one block of it fits; raises if not.  (Above 48 electrons the
    kernel runs another body, which takes no plan: ``csrc/fl_slogdet.cu``.)
    """
    groups = [g for g in range(D, 0, -1) if D % g == 0 and g * n <= FLAT_MAX_THREADS]
    fits = [g for g in groups
            if B * (D // g) >= 2 * sms and 2 * smem_bytes(n, g, FLAT_STAGES) <= limit]
    for G in fits + groups[-1:]:
        if smem_bytes(n, G, FLAT_STAGES) <= limit:
            return G
    raise ValueError(
        f'fl_slogdet: n={n} exceeds the {limit} B of shared memory a block can use'
    )


@functools.lru_cache(maxsize=None)
def _flat_plan_on(B, D, n, device):
    props = torch.cuda.get_device_properties(device)
    return flat_plan(B, D, n, props.multi_processor_count, _cuda.smem_limit(),
                     _cuda.library().fl_slogdet_traces_smem_bytes)


def slogdet_traces(inv, ju, jd):
    """tr(A_d^-1 J_{k,d}) and sum_k tr((A_d^-1 J_{k,d})^2) on flat row blocks
    (TPU kernel ``_pallas_blocked_flat_split``): kernel on the card, else plain."""
    if not inv.is_cuda:
        return slogdet_traces_plain(inv, ju, jd)
    validate(inv, ju, jd)
    B, D, n, _ = inv.shape
    K, nu, nd = ju.shape[1], ju.shape[2], jd.shape[2]
    jout = torch.empty((B, K, D), dtype=inv.dtype, device=inv.device)
    trq = torch.empty((B, D), dtype=inv.dtype, device=inv.device)
    with torch.cuda.device(inv.device):
        G = _flat_plan_on(B, D, n, torch.cuda.current_device())
        code = _cuda.library().fl_slogdet_traces_launch(
            *(x.data_ptr() for x in (inv, ju, jd, jout, trq)), B, D, K, nu, nd, G,
            FLAT_STAGES, _cuda.stream(),
        )
    _cuda.check(code, 'fl_slogdet_traces_launch')
    slogdet_traces.launches += 1
    return jout, trq


def square_traces(inv, ja, la):
    """(jout, lout) of :func:`square_traces_plain` (TPU kernel ``_pallas_blocked``):
    kernel on the card, else plain."""
    if not inv.is_cuda:
        return square_traces_plain(inv, ja, la)
    validate_square(inv, ja, la)
    return _launch(square_traces, 'fl_slogdet_square_launch', 'fl_slogdet_square_smem_bytes',
                   inv, (ja, la), ja.shape[1], (inv.shape[-1],))


def square_split_traces(inv, ju, jd, la):
    """(jout, lout) of :func:`square_split_traces_plain` (TPU kernel
    ``_pallas_blocked_split``): kernel on the card, else plain.  The column
    halves of A^-1 are read in place."""
    if not inv.is_cuda:
        return square_split_traces_plain(inv, ju, jd, la)
    validate_square_split(inv, ju, jd, la)
    return _launch(square_split_traces, 'fl_slogdet_square_split_launch',
                   'fl_slogdet_square_split_smem_bytes', inv, (ju, jd, la), ju.shape[1],
                   (ju.shape[3], jd.shape[3]))


slogdet_traces.launches = 0
square_traces.launches = 0
square_split_traces.launches = 0


# --- the FL log-determinant ---------------------------------------------------


def _primal(a):
    sign, logdet = torch.linalg.slogdet(a)
    inv = torch.linalg.inv(a).contiguous()  # cuSOLVER returns it column-major
    return sign, logdet, inv


def slogdet_fl_flat_split(a_flat, ju, jd, la, n_det):
    """(sign [B, D], log|det| [B, D], J [B, K, D], L [B, D]) of the flat slogdet."""
    sign, logdet, inv = _primal(unflatten_dets(a_flat, n_det))
    jout, trq = slogdet_traces(inv, ju, jd)
    lin = torch.einsum('bdij,bdji->bd', inv, unflatten_dets(la, n_det))
    return sign, logdet, jout, lin - trq


def slogdet_fl_square(a, ja, la):
    """(sign, log|det|, J, L) of a [B, D, n, n] with ja [B, K, D, n, n], la [B, D, n, n]."""
    sign, logdet, inv = _primal(a)
    return sign, logdet, *square_traces(inv, ja, la)


def slogdet_fl_square_split(a, ju, jd, la):
    """:func:`slogdet_fl_square` with the Jacobian in row blocks
    ju [B, K, D, nu, n] and jd [B, K, D, nd, n]."""
    sign, logdet, inv = _primal(a)
    return sign, logdet, *square_split_traces(inv, ju, jd, la)
