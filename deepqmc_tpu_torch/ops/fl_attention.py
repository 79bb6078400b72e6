"""Forward-Laplacian attention core (counterpart of ``deepqmc_tpu/ops/fl_attention.py``).

:func:`mha_core_fl` computes (t, J_t, L_t) of ``softmax(q k^T / sqrt(dh)) v``
per walker and head.  On a CPU tensor it runs the plain PyTorch version
:func:`mha_core_fl_plain`; on a CUDA tensor it launches the hand-written
kernel ``csrc/fl_attention.cu`` or raises (also for an operand that carries
a forward-mode tangent, which the kernel would drop).

Shapes: primals and Laplacians ``[B, n, H, dh]``; Jacobians ``[B, K, n, H, dh]``
(batch-major), with K the number of Laplacian directions.
"""

import functools

import torch

from . import _cuda

__all__ = ['mha_core_fl', 'mha_core_fl_plain']


def _softmax_fl(z, Jz, Lz):
    """Softmax over the last axis with Jacobian (direction axis 1) and Laplacian."""
    m = z - z.amax(dim=-1, keepdim=True)
    e = torch.exp(m)
    Je = e.unsqueeze(1) * Jz
    Le = e * (Lz + (Jz * Jz).sum(1))
    s = e.sum(-1, keepdim=True)
    Js = Je.sum(-1, keepdim=True)
    Ls = Le.sum(-1, keepdim=True)
    inv_s = 1.0 / s
    a = e * inv_s
    Ja = (Je - a.unsqueeze(1) * Js) * inv_s.unsqueeze(1)
    La = (
        (Le - a * Ls) * inv_s
        - 2 * inv_s**2 * (Je * Js).sum(1)
        + 2 * a * inv_s**2 * (Js * Js).sum(1)
    )
    return a, Ja, La


def mha_core_fl_plain(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv, mask=None):
    """Plain PyTorch version of the kernel; the CPU path and the kernel's oracle.
    A boolean ``mask`` ``[n, n]`` (query, key) leaves out the keys where it is
    False (logit -1e30 and no derivative there), which the kernel does not do."""
    scale = 1.0 / q.shape[-1] ** 0.5
    z = torch.einsum('bihd,bjhd->bhij', q, k) * scale
    Jz = (
        torch.einsum('bkihd,bjhd->bkhij', Jq, k) + torch.einsum('bihd,bkjhd->bkhij', q, Jk)
    ) * scale
    Lz = (
        torch.einsum('bihd,bjhd->bhij', Lq, k)
        + torch.einsum('bihd,bjhd->bhij', q, Lk)
        + 2 * torch.einsum('bkihd,bkjhd->bhij', Jq, Jk)
    ) * scale
    if mask is not None:
        z = torch.where(mask, z, -1e30)
        Jz, Lz = torch.where(mask, Jz, 0.0), torch.where(mask, Lz, 0.0)
    a, Ja, La = _softmax_fl(z, Jz, Lz)
    t = torch.einsum('bhij,bjhd->bihd', a, v)
    Jt = torch.einsum('bkhij,bjhd->bkihd', Ja, v) + torch.einsum('bhij,bkjhd->bkihd', a, Jv)
    Lt = (
        torch.einsum('bhij,bjhd->bihd', La, v)
        + torch.einsum('bhij,bjhd->bihd', a, Lv)
        + 2 * torch.einsum('bkhij,bkjhd->bihd', Ja, Jv)
    )
    return t, Jt, Lt


MAX_N = 64  # tokens the kernel takes (pass A's row group of at most 32 lanes)
MAX_SLOTS = 5  # [n, dh] tiles in the kernel's copy ring; more cost blocks an SM (PERF.md)
MIN_SLOTS = 3  # one direction's Jq, Jk and Jv


@functools.lru_cache(maxsize=None)
def _pick_slots(n: int, dh: int, device: int) -> int:
    """Tiles in the kernel's copy ring on ``device``: the most that fit, at most
    MAX_SLOTS."""
    lib, limit = _cuda.library(), _cuda.smem_limit()
    for slots in range(MAX_SLOTS, MIN_SLOTS - 1, -1):
        if lib.fl_attention_smem_bytes(n, dh, slots) <= limit:
            return slots
    raise ValueError(
        f'fl_attention: n={n}, dh={dh} exceed the {limit} B of shared memory a block '
        f'can use (the [n, dh] tiles, the [n, n] sums and a ring of {MIN_SLOTS} tiles '
        'must fit)'
    )


def validate(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv):
    """Raise unless the operands are what the kernel takes: float32 on one
    device, contiguous and 16-byte aligned, primals [B, n, H, dh] and
    Jacobians [B, K, n, H, dh], n <= 64 and dh a multiple of 4."""
    B, n, H, dh = q.shape
    K = Jq.shape[1]
    if n > MAX_N or dh % 4:
        raise ValueError(
            f'fl_attention: needs n <= {MAX_N} (a row of the softmax in one warp, two '
            f'columns a lane) and dh % 4 == 0 (16-byte copies), got n={n}, dh={dh}'
        )
    for name, x, shape in (
        *((nm, x, (B, n, H, dh)) for nm, x in zip(('q', 'k', 'v', 'Lq', 'Lk', 'Lv'),
                                                 (q, k, v, Lq, Lk, Lv))),
        *((nm, x, (B, K, n, H, dh)) for nm, x in zip(('Jq', 'Jk', 'Jv'), (Jq, Jk, Jv))),
    ):
        if x.device != q.device or x.dtype != torch.float32:
            raise TypeError(f'fl_attention: {name} must be float32 on {q.device}')
        if tuple(x.shape) != shape:
            raise ValueError(f'fl_attention: {name} has shape {tuple(x.shape)}, want {shape}')
        if not x.is_contiguous():
            raise ValueError(f'fl_attention: {name} must be contiguous')
        if x.data_ptr() % 16:
            raise ValueError(f'fl_attention: {name} must be 16-byte aligned')


def _launch(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv):
    _cuda.refuse_tangents('fl_attention', q, k, v, Jq, Jk, Jv, Lq, Lk, Lv)
    validate(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv)
    B, n, H, dh = q.shape
    K = Jq.shape[1]
    t, Lt = torch.empty_like(q), torch.empty_like(q)
    Jt = torch.empty_like(Jq)
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        slots = _pick_slots(n, dh, torch.cuda.current_device())
        code = lib.fl_attention_launch(
            *(x.data_ptr() for x in (q, k, v, Jq, Jk, Jv, Lq, Lk, Lv, t, Jt, Lt)),
            B, K, n, H, dh, slots, _cuda.stream(),
        )
    _cuda.check(code, 'fl_attention')
    mha_core_fl.launches += 1
    return t, Jt, Lt


def mha_core_fl(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv):
    """(t, J_t, L_t) of the attention core: the CUDA kernel on the card, else plain."""
    if q.is_cuda:
        return _launch(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv)
    return mha_core_fl_plain(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv)


mha_core_fl.launches = 0
