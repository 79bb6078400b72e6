"""Forward-Laplacian log-determinant on the flat layout (counterpart of
``deepqmc_tpu/ops/fl_slogdet.py``).

For the flat det-major orbital matrix ``a_flat`` ``[B, n, D*n]`` (column
``d*n + j`` is orbital j of determinant d) whose Jacobian arrives as up/down
row blocks ``ju`` ``[B, K, nu, D*n]`` and ``jd`` ``[B, K, nd, D*n]``:

    J_k log|det A_d| = tr(A_d^-1 J_{k,d})
    L log|det A_d|   = tr(A_d^-1 L_d) - sum_k tr((A_d^-1 J_{k,d})^2)

The primal sign, log|det| and inverse use ``torch.linalg`` (the JAX package
also keeps them outside its kernel).  The two traces are
:func:`slogdet_traces`: on a CPU tensor the plain version
:func:`slogdet_traces_plain`, on a CUDA tensor the hand-written kernel
``csrc/fl_slogdet.cu`` or an error.
"""

import torch

from . import _cuda
from .slogdet import unflatten_dets

__all__ = ['slogdet_fl_flat_split', 'slogdet_traces', 'slogdet_traces_plain']


def _unpack_jac(ju, jd, n_det):
    """Row blocks [B, K, rows, D*n] -> [B, K, D, n, n]."""
    j = torch.cat([ju, jd], dim=-2)
    return j.unflatten(-1, (n_det, -1)).movedim(-2, -3)


def slogdet_traces_plain(inv, ju, jd):
    """(jout [B, K, D], trq [B, D]) from the inverse [B, D, n, n] and row blocks."""
    j = _unpack_jac(ju, jd, inv.shape[1])
    jout = torch.einsum('bdij,bkdji->bkd', inv, j)
    m = torch.einsum('bdij,bkdjl->bkdil', inv, j)
    trq = torch.einsum('bkdij,bkdji->bd', m, m)
    return jout, trq


MAX_N = 32  # electrons per determinant the kernel takes (a register row of m)


def _check_smem(n: int):
    lib, limit = _cuda.library(), _cuda.smem_limit()
    if lib.fl_slogdet_smem_bytes(n) > limit:
        raise ValueError(f'fl_slogdet: n={n} exceeds the {limit} B of shared memory a block can use')


def validate(inv, ju, jd):
    """Raise unless the operands are what the kernel takes: float32 on one
    device, contiguous, inv [B, D, n, n], ju [B, K, nu, D*n], jd [B, K, nd, D*n]."""
    B, D, n, _ = inv.shape
    K, nu = ju.shape[1], ju.shape[2]
    nd = jd.shape[2]
    if n > MAX_N:
        raise ValueError(f'fl_slogdet: n={n} > {MAX_N} electrons per determinant')
    for name, x, shape in (
        ('inv', inv, (B, D, n, n)),
        ('ju', ju, (B, K, nu, D * n)),
        ('jd', jd, (B, K, nd, D * n)),
    ):
        if x.device != inv.device or x.dtype != torch.float32:
            raise TypeError(f'fl_slogdet: {name} must be float32 on {inv.device}')
        if tuple(x.shape) != shape:
            raise ValueError(f'fl_slogdet: {name} has shape {tuple(x.shape)}, want {shape}')
        if not x.is_contiguous():
            raise ValueError(f'fl_slogdet: {name} must be contiguous')


def _launch(inv, ju, jd):
    validate(inv, ju, jd)
    B, D, n, _ = inv.shape
    K, nu, nd = ju.shape[1], ju.shape[2], jd.shape[2]
    _check_smem(n)
    jout = torch.empty((B, K, D), dtype=inv.dtype, device=inv.device)
    trq = torch.empty((B, D), dtype=inv.dtype, device=inv.device)
    lib = _cuda.library()
    with torch.cuda.device(inv.device):
        code = lib.fl_slogdet_traces_launch(
            inv.data_ptr(), ju.data_ptr(), jd.data_ptr(), jout.data_ptr(), trq.data_ptr(),
            B, D, K, nu, nd, _cuda.stream(),
        )
    _cuda.check(code, 'fl_slogdet')
    slogdet_traces.launches += 1
    return jout, trq


def slogdet_traces(inv, ju, jd):
    """tr(A_d^-1 J_{k,d}) and sum_k tr((A_d^-1 J_{k,d})^2): kernel on the card, else plain."""
    if inv.is_cuda:
        return _launch(inv, ju, jd)
    return slogdet_traces_plain(inv, ju, jd)


slogdet_traces.launches = 0


def slogdet_fl_flat_split(a_flat, ju, jd, la, n_det):
    """(sign [B, D], log|det| [B, D], J [B, K, D], L [B, D]) of the flat slogdet."""
    a = unflatten_dets(a_flat, n_det)
    sign, logdet = torch.linalg.slogdet(a)
    inv = torch.linalg.inv(a).contiguous()  # cuSOLVER returns it column-major
    jout, trq = slogdet_traces(inv, ju, jd)
    lin = torch.einsum('bdij,bdji->bd', inv, unflatten_dets(la, n_det))
    return sign, logdet, jout, lin - trq
