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

The Jacobian operands may be stored in bfloat16 (``DEEPQMC_TPU_JAC_DTYPE=
bf16``): the kernels read them so (the stages hold bf16, half the bytes) and
widen each value as they load it; the plain versions upcast them.  The
inverse, the Laplacian and the outputs stay float32.

All three launch one of two bodies of the library, picked by n
(``fl_slogdet_body``): the staged body (a block per walker and group of G
determinants) at small n, the tiled body (a block per walker and
determinant, 4 x 4 register tiles of m) at large n.  :func:`plan` gives G and
the ring's depth S, and :func:`row_blocks` the layout record that tells the
kernel where a direction's rows lie and how to copy them.
"""

import collections
import ctypes
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

MAX_N = 64  # electrons per determinant the kernels take (16 x 16 tiles in the tiled body)


# --- plain versions -----------------------------------------------------------


def _traces(inv, j):
    """(tr(A^-1 J_k) [B, K, D], sum_k tr((A^-1 J_k)^2) [B, D]) on the square layout;
    ``j`` in a lower dtype than ``inv`` is upcast."""
    j = j.to(inv.dtype)
    jout = torch.einsum('bdij,bkdji->bkd', inv, j)
    m = torch.einsum('bdij,bkdjl->bkdil', inv, j)
    trq = torch.einsum('bkdij,bkdji->bd', m, m)
    return jout, trq


def slogdet_traces_plain(inv, ju, jd):
    """(jout [B, K, D], trq [B, D]) from the inverse [B, D, n, n] and flat row blocks
    (upcast where they are stored lower)."""
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


JDTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the library's Jacobian element types


def _check(inv, *named):
    """Raise unless ``inv`` is [B, D, n, n] with n <= MAX_N, every operand is on
    its device, contiguous and of its shape, and float32, but for the Jacobian
    operands (named j*), which may all be bfloat16 instead."""
    B, D, n, _ = inv.shape
    if n > MAX_N:
        raise ValueError(f'fl_slogdet: n={n} > {MAX_N} electrons per determinant')
    jdtype = named[0][1].dtype
    if jdtype not in JDTYPES:
        raise TypeError(f'fl_slogdet: the Jacobian must be float32 or bfloat16, got {jdtype}')
    for name, x, shape in (('inv', inv, (B, D, n, n)), *named):
        dtype = jdtype if name.startswith('j') else torch.float32
        if x.device != inv.device or x.dtype != dtype:
            raise TypeError(f'fl_slogdet: {name} must be {dtype} on {inv.device}')
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

# Layouts and bodies of ``csrc/fl_slogdet.cu`` (its ``Layout`` and ``Body``).
FLAT, SQUARE, SQUARE_SPLIT = 0, 1, 2
STAGED, TILED = 0, 1

FLAT_MAX_THREADS = 256  # a staged block: at most one thread per (determinant, row)
# Directions in the staged body's copy ring: two on their way while one is in
# use.  More stages cost blocks per SM, which the kernel needs more (PERF.md).
FLAT_STAGES = 3
STAGED_MAX_N = 48  # the staged body's largest instance
TILED_STAGES = (4, 3, 2)  # the tiled body's ring depths, deepest first
# An H100 SM: shared memory, of which each resident block costs 1 KB more than
# it asks for, resident threads and resident blocks.
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
SM_MAX_THREADS, SM_MAX_BLOCKS = 2048, 32

Plan = collections.namedtuple('Plan', 'body G S')


class RowBlocks(ctypes.Structure):
    """The layout record of ``csrc/fl_slogdet.cu`` (``RowBlocks``), in elements
    of the Jacobian (floats, or bf16 values of a bf16 Jacobian: "4 floats"
    below are then 8 of them, 16 bytes).

    In memory, determinant d's up row r of (walker b, direction k) lies at
    ``ju + (b K + k) up_bk + d up_d + r row``, its down rows likewise in
    ``jd``.  In a stage of the kernel's ring, determinant g of the block's
    group has its up row r at ``g s_up_d + r s_row`` and its down row r at
    ``s_dn + g s_dn_d + r s_row``; a stage is ``stage`` floats.  ``runs``:
    each block (up, down) of the group is one run of G nu n (G nd n) floats,
    laid out in the stage as in memory; else one copy a row of G n floats.
    ``vw``: floats a copy, 4 by TMA, 2 or 1 by ``cp.async``.  ``align``: the
    floats both pointers are aligned to.  ``shift``: a square layout's runs,
    not all 16-byte aligned, each land 0 to 3 floats past their place (their
    address mod 16 bytes, the same for every direction where the (walker,
    direction) strides are multiples of 4 floats), the 16-byte-aligned
    interior by TMA, the ends by plain copies, in place of copies of vw floats.
    """

    _fields_ = [(name, ctypes.c_long) for name in (
        'up_bk', 'up_d', 'dn_bk', 'dn_d', 'row', 's_up_d', 's_dn', 's_dn_d', 's_row', 'stage',
        'runs', 'vw', 'align', 'shift')]


def _up(x, v):
    return -(-x // v) * v


def row_blocks(layout, D, nu, nd, G, align=16, esize=4):
    """The layout record of a block of G determinants whose Jacobian has
    elements of ``esize`` bytes (4 float32, 2 bfloat16); ``align``, the bytes
    both Jacobian pointers are aligned to (a power of 2), sets how wide a copy
    may be.  The flat stage keeps the group's G n columns of each row (rows
    padded to 4 floats); the square stages hold the group's runs as they lie
    in memory (with 3 floats of room each where they are shifted), the down
    run from the first 4-float boundary after the up run.  (The kernels derive the
    stage half from the layout too, ``stage_rows``, and refuse a launch whose
    record disagrees.)"""
    n, V = nu + nd, 16 // esize  # V: elements in 16 bytes
    if layout == FLAT:
        Dn, ldr = D * n, _up(G * n, V)
        rb = RowBlocks(nu * Dn, n, nd * Dn, n, Dn, n, nu * ldr, n, ldr, n * ldr,
                       int(G == D and ldr == Dn), 1, max(1, align // esize), 0)
    else:  # SQUARE is SQUARE_SPLIT with nu = n, nd = 0
        up_d, dn_d = nu * n, nd * n
        rb = RowBlocks(D * up_d, up_d, D * dn_d, dn_d, n, up_d, 0, dn_d, n, 0, 1, 1,
                       max(1, align // esize), 0)
    # every start, in memory and in the stage, and every length a multiple of vw
    counts = [rb.up_bk, G * rb.up_d, G * n * nu if rb.runs else G * n]
    if not rb.runs:
        counts += [rb.row, rb.s_row]
    if nd:
        counts += [rb.dn_bk, G * rb.dn_d, rb.s_dn] + ([G * n * nd] if rb.runs else [])
    widths = [V >> i for i in range(V.bit_length())]  # V, V / 2, .., 1
    rb.vw = next(v for v in widths if esize * v <= align and all(c % v == 0 for c in counts))
    if layout != FLAT:
        rb.shift = int(rb.vw < V and rb.up_bk % V == 0 and rb.dn_bk % V == 0)
        room = V - 1 if rb.shift else 0
        rb.s_dn = _up(G * nu * n + room, V)
        rb.stage = rb.s_dn + (_up(G * nd * n + room, V) if nd else 0)
    return rb


def tiled_threads(n):
    """Threads of a tiled block: one per 4 x 4 tile of the [np, np] product
    (np = n rounded up to 4), rounded up to whole warps."""
    nt = -(-n // 4)
    return -(-nt * nt // 32) * 32


def flat_plan(B, D, n, sms, limit, smem_bytes):
    """G, the determinants a block of the staged body takes (every layout).

    The largest divisor of D with G n <= FLAT_MAX_THREADS that gives each of
    the ``sms`` SMs two blocks of the grid and fits two blocks in an SM's
    ``limit`` bytes by ``smem_bytes(n, G, FLAT_STAGES)``: the kernel waits on
    its loads and needs blocks in flight more than determinants a block.
    Else 1, if one block of it fits; raises if not.
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


def tiled_stages(B, D, n, sms, limit, smem_bytes, sm_bytes=SM_SHARED_BYTES):
    """S, the directions in the tiled body's ring (one block per walker and
    determinant): the deepest of TILED_STAGES that costs no block an SM, where
    an SM wants as many blocks as the grid gives it, up to its threads' and
    blocks' limits; ``smem_bytes(S)`` is a block's shared memory.  Raises if no ring
    fits in ``limit`` bytes."""
    want = min(-(-B * D // sms), SM_MAX_THREADS // tiled_threads(n), SM_MAX_BLOCKS)
    fits = [S for S in TILED_STAGES if smem_bytes(S) <= limit]
    if not fits:
        raise ValueError(
            f'fl_slogdet: n={n} exceeds the {limit} B of shared memory a block can use'
        )
    return max(fits, key=lambda S: (
        min(want, sm_bytes // (smem_bytes(S) + BLOCK_RESERVED_BYTES)), S))


def plan(layout, body, B, D, nu, nd, sms, limit, smem_bytes, sm_bytes=SM_SHARED_BYTES,
         esize=4):
    """The launch plan (body, G, S) of ``body`` for ``layout`` with Jacobian
    elements of ``esize`` bytes; ``smem_bytes(body, n, G, S, stage)`` is a
    block's shared memory with stages of ``stage`` such elements (the
    library's ``fl_slogdet_smem_bytes``)."""
    n = nu + nd

    def smem(G, S):
        return smem_bytes(body, n, G, S, row_blocks(layout, D, nu, nd, G, esize=esize).stage)

    if body == STAGED:
        if n > STAGED_MAX_N:
            raise ValueError(f'fl_slogdet: the staged body takes n <= {STAGED_MAX_N}, got {n}')
        return Plan(STAGED, flat_plan(B, D, n, sms, limit, lambda _, G, S: smem(G, S)),
                    FLAT_STAGES)
    return Plan(TILED, 1, tiled_stages(B, D, n, sms, limit, lambda S: smem(1, S), sm_bytes))


@functools.lru_cache(maxsize=None)
def _plan_on(layout, B, D, nu, nd, device, body, esize):
    lib = _cuda.library()
    if body is None:
        body = lib.fl_slogdet_body(layout, nu + nd)
    props = torch.cuda.get_device_properties(device)
    return plan(layout, body, B, D, nu, nd, props.multi_processor_count, _cuda.smem_limit(),
                lambda *args: lib.fl_slogdet_smem_bytes(*args, esize),
                getattr(props, 'shared_memory_per_multiprocessor', SM_SHARED_BYTES), esize)


_row_blocks_on = functools.lru_cache(maxsize=None)(row_blocks)  # one record per shape: host time


def _align(*tensors):
    """The largest of 16, 8, 4, 2 bytes that every non-empty tensor's pointer is aligned to."""
    bits = 0
    for t in tensors:
        if t.numel():
            bits |= t.data_ptr()
    return next(a for a in (16, 8, 4, 2) if bits % a == 0)


def _launch(counter, layout, entry, inv, jacobians, la, K, nu, nd, body):
    """Launch ``entry`` on the inverse, the Jacobian operands (and ``la``);
    (jout, out).  ``body`` None takes the body by n, as the library says."""
    _cuda.refuse_tangents(entry, inv, *jacobians, la)
    B, D, n, _ = inv.shape
    jdtype, esize = jacobians[0].dtype, jacobians[0].element_size()
    jout = torch.empty((B, K, D), dtype=inv.dtype, device=inv.device)
    out = torch.empty((B, D), dtype=inv.dtype, device=inv.device)
    sizes = (nu, nd) if layout != SQUARE else (n,)
    with torch.cuda.device(inv.device):
        p = _plan_on(layout, B, D, nu, nd, inv.device.index, body, esize)
        rows = _row_blocks_on(layout, D, nu, nd, p.G, _align(*jacobians), esize)
        code = getattr(_cuda.library(), entry)(
            inv.data_ptr(), *(x.data_ptr() for x in jacobians),
            *((la.data_ptr(),) if la is not None else ()), jout.data_ptr(), out.data_ptr(),
            B, D, K, *sizes, p.body, p.G, p.S, JDTYPES[jdtype], ctypes.addressof(rows),
            _cuda.stream(),
        )
    _cuda.check(code, entry)
    counter.launches += 1
    counter.by_dtype[jdtype] += 1
    counter.last_plan = p
    return jout, out


def slogdet_traces(inv, ju, jd, *, body=None):
    """tr(A_d^-1 J_{k,d}) and sum_k tr((A_d^-1 J_{k,d})^2) on flat row blocks
    (TPU kernel ``_pallas_blocked_flat_split``): kernel on the card, else plain.
    ``body`` (STAGED or TILED) overrides the library's choice by n, for timing."""
    if not inv.is_cuda:
        return slogdet_traces_plain(inv, ju, jd)
    validate(inv, ju, jd)
    return _launch(slogdet_traces, FLAT, 'fl_slogdet_traces_launch', inv, (ju, jd), None,
                   ju.shape[1], ju.shape[2], jd.shape[2], body)


def square_traces(inv, ja, la, *, body=None):
    """(jout, lout) of :func:`square_traces_plain` (TPU kernel ``_pallas_blocked``):
    kernel on the card, else plain; ``body`` as in :func:`slogdet_traces`."""
    if not inv.is_cuda:
        return square_traces_plain(inv, ja, la)
    validate_square(inv, ja, la)
    return _launch(square_traces, SQUARE, 'fl_slogdet_square_launch', inv, (ja,), la,
                   ja.shape[1], inv.shape[-1], 0, body)


def square_split_traces(inv, ju, jd, la, *, body=None):
    """(jout, lout) of :func:`square_split_traces_plain` (TPU kernel
    ``_pallas_blocked_split``): kernel on the card, else plain; ``body`` as in
    :func:`slogdet_traces`.  The column halves of A^-1 are read in place."""
    if not inv.is_cuda:
        return square_split_traces_plain(inv, ju, jd, la)
    validate_square_split(inv, ju, jd, la)
    return _launch(square_split_traces, SQUARE_SPLIT, 'fl_slogdet_square_split_launch', inv,
                   (ju, jd), la, ju.shape[1], ju.shape[3], jd.shape[3], body)


# launches, their split by Jacobian dtype, and the last launch's plan
for _counter in (slogdet_traces, square_traces, square_split_traces):
    _counter.launches, _counter.by_dtype, _counter.last_plan = 0, collections.Counter(), None


# --- the FL log-determinant ---------------------------------------------------


def _primal(a):
    sign, logdet = torch.linalg.slogdet(a)
    inv = torch.linalg.inv(a).contiguous()  # cuSOLVER returns it column-major
    return sign, logdet, inv


def slogdet_fl_flat_split(a_flat, ju, jd, la, n_det, *, plain: bool = False):
    """(sign [B, D], log|det| [B, D], J [B, K, D], L [B, D]) of the flat slogdet;
    the traces by their plain version on any device with ``plain``."""
    sign, logdet, inv = _primal(unflatten_dets(a_flat, n_det))
    jout, trq = (slogdet_traces_plain if plain else slogdet_traces)(inv, ju, jd)
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
