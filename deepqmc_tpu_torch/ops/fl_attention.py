"""Forward-Laplacian attention core (counterpart of ``deepqmc_tpu/ops/fl_attention.py``).

:func:`mha_core_fl` computes (t, J_t, L_t) of ``softmax(q k^T / sqrt(dh)) v``
per walker and head.  On a CPU tensor it runs the plain PyTorch version
:func:`mha_core_fl_plain`; on a CUDA tensor it launches the hand-written
kernel ``csrc/fl_attention.cu`` or raises (also for an operand that carries
a forward-mode tangent, which the kernel would drop).

Shapes: primals and Laplacians ``[B, n, H, dh]``; Jacobians ``[B, K, n, H, dh]``
(batch-major), with K the number of Laplacian directions.

The Jacobians may be stored in bfloat16 (``DEEPQMC_TPU_JAC_DTYPE=bf16``): the
kernel reads them so and widens them after the load, computes in float32 and
writes J_t at their dtype; the plain version upcasts them and rounds J_t so.
With ``low`` (the JAX kernel's ``_jac_bmm_low``, on under
``DEEPQMC_TPU_JAC_MATMUL=bf16`` at float32) the Jacobian contractions, those
that scale with K, take both operands rounded to bfloat16 and accumulate in
float32, as ``_bmm(low=True)`` does; the primal and Laplacian ones do not.
"""

import collections
import functools

import torch

from . import _cuda

__all__ = ['mha_core_fl', 'mha_core_fl_plain', 'round_bf16']


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (nearest even) and back to its dtype: a bf16
    operand in the arithmetic of ``t``'s dtype, whose products are exact in
    float32."""
    return t.to(torch.bfloat16).to(t.dtype)


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


def mha_core_fl_plain(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv, mask=None, low=False):
    """Plain PyTorch version of the kernel; the CPU path and the kernel's oracle.
    A boolean ``mask`` ``[n, n]`` (query, key) leaves out the keys where it is
    False (logit -1e30 and no derivative there), which the kernel does not do.
    Jacobians in another dtype than ``q`` are upcast, and J_t comes back in
    theirs; ``low`` rounds the operands of the Jacobian contractions to bf16."""
    jdtype = Jq.dtype
    Jq, Jk, Jv = (J.to(q.dtype) for J in (Jq, Jk, Jv))
    r = round_bf16 if low else (lambda x: x)
    scale = 1.0 / q.shape[-1] ** 0.5
    z = torch.einsum('bihd,bjhd->bhij', q, k) * scale
    Jz = (
        torch.einsum('bkihd,bjhd->bkhij', r(Jq), r(k))
        + torch.einsum('bihd,bkjhd->bkhij', r(q), r(Jk))
    ) * scale
    Lz = (
        torch.einsum('bihd,bjhd->bhij', Lq, k)
        + torch.einsum('bihd,bjhd->bhij', q, Lk)
        + 2 * torch.einsum('bkihd,bkjhd->bhij', r(Jq), r(Jk))
    ) * scale
    if mask is not None:
        z = torch.where(mask, z, -1e30)
        Jz, Lz = torch.where(mask, Jz, 0.0), torch.where(mask, Lz, 0.0)
    a, Ja, La = _softmax_fl(z, Jz, Lz)
    t = torch.einsum('bhij,bjhd->bihd', a, v)
    Jt = (torch.einsum('bkhij,bjhd->bkihd', r(Ja), r(v))
          + torch.einsum('bhij,bkjhd->bkihd', r(a), r(Jv)))
    Lt = (
        torch.einsum('bhij,bjhd->bihd', La, v)
        + torch.einsum('bhij,bjhd->bihd', a, Lv)
        + 2 * torch.einsum('bkhij,bkjhd->bihd', r(Ja), r(Jv))
    )
    return t, Jt.to(jdtype), Lt


MAX_N = 64  # tokens the kernel takes (pass A's row group of at most 32 lanes)
MAX_SLOTS = 5  # [n, dh] tiles in the kernel's copy ring; more cost blocks an SM (PERF.md)
MIN_SLOTS = 3  # one direction's Jq, Jk and Jv


JDTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the library's Jacobian element types


@functools.lru_cache(maxsize=None)
def _pick_slots(n: int, dh: int, jbytes: int, device: int) -> int:
    """Tiles in the kernel's copy ring on ``device`` (Jacobian elements of
    ``jbytes`` bytes): the most that fit, at most MAX_SLOTS."""
    lib, limit = _cuda.library(), _cuda.smem_limit()
    for slots in range(MAX_SLOTS, MIN_SLOTS - 1, -1):
        if lib.fl_attention_smem_bytes(n, dh, slots, jbytes) <= limit:
            return slots
    raise ValueError(
        f'fl_attention: n={n}, dh={dh} exceed the {limit} B of shared memory a block '
        f'can use (the [n, dh] tiles, the [n, n] sums and a ring of {MIN_SLOTS} tiles '
        'must fit)'
    )


def validate(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv):
    """Raise unless the operands are what the kernel takes: on one device,
    contiguous and 16-byte aligned, primals [B, n, H, dh] in float32 and
    Jacobians [B, K, n, H, dh] all in float32 or all in bfloat16, n <= 64 and
    dh a multiple of 4 (of 8 for bfloat16 Jacobians: 16-byte copies)."""
    B, n, H, dh = q.shape
    K = Jq.shape[1]
    if Jq.dtype not in JDTYPES:
        raise TypeError(f'fl_attention: Jq must be float32 or bfloat16, got {Jq.dtype}')
    vec = 16 // Jq.element_size()
    if n > MAX_N or dh % 4 or dh % vec:
        raise ValueError(
            f'fl_attention: needs n <= {MAX_N} (a row of the softmax in one warp, two '
            f'columns a lane) and dh % {max(4, vec)} == 0 (16-byte copies), got n={n}, dh={dh}'
        )
    for name, x, shape, dtype in (
        *((nm, x, (B, n, H, dh), torch.float32)
          for nm, x in zip(('q', 'k', 'v', 'Lq', 'Lk', 'Lv'), (q, k, v, Lq, Lk, Lv))),
        *((nm, x, (B, K, n, H, dh), Jq.dtype) for nm, x in zip(('Jq', 'Jk', 'Jv'), (Jq, Jk, Jv))),
    ):
        if x.device != q.device or x.dtype != dtype:
            raise TypeError(f'fl_attention: {name} must be {dtype} on {q.device}')
        if tuple(x.shape) != shape:
            raise ValueError(f'fl_attention: {name} has shape {tuple(x.shape)}, want {shape}')
        if not x.is_contiguous():
            raise ValueError(f'fl_attention: {name} must be contiguous')
        if x.data_ptr() % 16:
            raise ValueError(f'fl_attention: {name} must be 16-byte aligned')


def _launch(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv, low=False):
    _cuda.refuse_tangents('fl_attention', q, k, v, Jq, Jk, Jv, Lq, Lk, Lv)
    validate(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv)
    B, n, H, dh = q.shape
    K = Jq.shape[1]
    t, Lt = torch.empty_like(q), torch.empty_like(q)
    Jt = torch.empty_like(Jq)  # at the Jacobians' dtype
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        slots = _pick_slots(n, dh, Jq.element_size(), torch.cuda.current_device())
        code = lib.fl_attention_launch(
            *(x.data_ptr() for x in (q, k, v, Jq, Jk, Jv, Lq, Lk, Lv, t, Jt, Lt)),
            B, K, n, H, dh, slots, JDTYPES[Jq.dtype], int(low), _cuda.stream(),
        )
    _cuda.check(code, 'fl_attention')
    mha_core_fl.launches += 1
    mha_core_fl.by_dtype[Jq.dtype, bool(low)] += 1
    return t, Jt, Lt


def mha_core_fl(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv, low=False):
    """(t, J_t, L_t) of the attention core: the CUDA kernel on the card, else plain."""
    if q.is_cuda:
        return _launch(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv, low)
    return mha_core_fl_plain(q, k, v, Jq, Jk, Jv, Lq, Lk, Lv, low=low)


# launches, and their split by (Jacobian dtype, low)
mha_core_fl.launches, mha_core_fl.by_dtype = 0, collections.Counter()
