"""Forward Laplacian of a whole PsiFormer layer (counterpart of
``deepqmc_tpu/ops/fl_block.py`` ``block_fl_call`` for the one block the
PsiFormer fuses, ``gnn/update_features.py``'s ``_psiformer_block``).

Per walker, on the FL triple of ``h`` it computes the FL triple of

    att = h + mha_core(h Wq, h Wk, h Wv) Wo
    y   = att + tanh(tanh(att W1 + b1) W2 + b2)

with ``Wq``, ``Wk``, ``Wv`` ``[d, H*dh]`` (no bias, ``H*dh = d``), ``Wo``,
``W1``, ``W2`` ``[d, d]`` and ``b1``, ``b2`` ``[d]``, weights in the JAX
layout ``[in, out]``.  :func:`psiformer_block_fl` runs the plain PyTorch
version :func:`psiformer_block_fl_plain` on a CPU tensor and the hand-written
kernel ``csrc/fl_block.cu`` on a CUDA tensor, or raises (also for an operand
that carries a forward-mode tangent).  The kernel runs the
six d x d products on the tensor cores in split TF32 (three TF32 products per
float32 one), to float32 accuracy.

Shapes: ``x`` and ``L`` ``[B, n, d]``, ``J`` ``[B, K, n, d]`` (batch-major),
with K the number of Laplacian directions.
"""

import torch

from .. import fwdlap as fl
from . import _cuda
from .fl_attention import mha_core_fl_plain

__all__ = [
    'psiformer_block_fl', 'psiformer_block_fl_plain', 'takes', 'validate', 'weight_bytes',
]

MAX_N = 32  # tokens the kernel takes
MAX_ROWS = 64  # kc * n, the rows of one chunk's products: one 64-row tensor-core tile
SCRATCH = 8  # [n, d] arrays per walker the kernel keeps in global memory (kScratch)


def takes(x) -> bool:
    """Whether the block path takes a layer whose FL triple has primal ``x``
    ``[B, n, d]``: on the card only up to MAX_N tokens, where the kernel's
    [n, d] tiles fit a block's shared memory (at n = 64 the q, k and v tiles
    alone need 196 KB of the 227 KB); on the CPU always (the plain version).
    A layer the block path does not take runs the per-op FL rules (kernel 1
    and the library's products), as the JAX package's block rule returns to
    per-primitive interpretation where a block is not fusable.  The decision
    reads the shape and the device only, so the launch counters show the
    route taken."""
    return not x.is_cuda or x.shape[-2] <= MAX_N


def psiformer_block_fl_plain(x, J, L, wq, wk, wv, wo, w1, b1, w2, b2, num_heads: int):
    """Plain PyTorch version of the kernel: the port's FL rules composed with
    :func:`~.fl_attention.mha_core_fl_plain`.  The CPU path and the kernel's oracle.
    Like the kernel, it keeps its Jacobians in the primal's dtype whatever the
    Jacobian levers say (the JAX package's block rule upcasts its operands and
    stores only its output); the caller's FL stores that output."""
    with fl.jac_levers(fl.Levers()):
        h = fl.FL(x, J.to(x.dtype), L)
        att = h + fl.mha_core(h @ wq, h @ wk, h @ wv, num_heads, core=mha_core_fl_plain) @ wo
        y = att + fl.tanh(fl.tanh(att @ w1 + b1) @ w2 + b2)
        return y.x, y.jac, y.lap


def validate(x, J, L, wq, wk, wv, wo, w1, b1, w2, b2, num_heads: int):
    """Raise unless the operands are what the kernel takes: float32 on one
    device, contiguous and 16-byte aligned, x and L [B, n, d], J [B, K, n, d],
    the weights [d, d] and the biases [d], with n <= 32, d = H * dh and
    dh % 4 == 0 (float4 rows within a head)."""
    B, n, d = x.shape
    K = J.shape[1]
    if n > MAX_N:
        raise ValueError(f'fl_block: needs n <= {MAX_N}, got n={n}')
    if d % num_heads or (d // num_heads) % 4:
        raise ValueError(
            f'fl_block: needs d = H * dh with dh % 4 == 0, got d={d}, H={num_heads}'
        )
    named = (
        ('x', x, (B, n, d)), ('J', J, (B, K, n, d)), ('L', L, (B, n, d)),
        *((nm, w, (d, d)) for nm, w in zip(('wq', 'wk', 'wv', 'wo', 'w1', 'w2'),
                                           (wq, wk, wv, wo, w1, w2))),
        ('b1', b1, (d,)), ('b2', b2, (d,)),
    )
    for name, t, shape in named:
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f'fl_block: {name} must be float32 on {x.device}')
        if tuple(t.shape) != shape:
            raise ValueError(f'fl_block: {name} has shape {tuple(t.shape)}, want {shape}')
        if not t.is_contiguous():
            raise ValueError(f'fl_block: {name} must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'fl_block: {name} must be 16-byte aligned')


def _pick_kc(K: int, n: int, d: int, H: int) -> int:
    """Directions per chunk: the most that fit in shared memory with kc * n <= 64."""
    lib, limit = _cuda.library(), _cuda.smem_limit()
    for kc in range(min(K, MAX_ROWS // n), 0, -1):
        if lib.fl_block_smem_bytes(n, d, H, kc) <= limit:
            return kc
    raise ValueError(
        f'fl_block: n={n}, d={d}, H={H} exceed the {limit} B of shared memory a block can '
        'use (the primal [n, d] tiles, the K-sums, the weight ring and one direction must fit)'
    )


def weight_bytes(B: int, K: int, n: int, d: int, H: int) -> int:
    """Weight bytes one launch reads from L2, by the kernel's staging plan (the
    header of ``csrc/fl_block.cu``): each block reads the six d x d weights once
    for the primal pass and once for each chunk of kc directions, and Wo, W1, W2
    once more for the Laplacian pass."""
    chunks = -(-K // _pick_kc(K, n, d, H))
    return 4 * B * d * d * (6 * (1 + chunks) + 3)


def _launch(x, J, L, wq, wk, wv, wo, w1, b1, w2, b2, num_heads):
    _cuda.refuse_tangents('fl_block', x, J, L, wq, wk, wv, wo, w1, b1, w2, b2)
    validate(x, J, L, wq, wk, wv, wo, w1, b1, w2, b2, num_heads)
    B, n, d = x.shape
    K = J.shape[1]
    kc = _pick_kc(K, n, d, num_heads)
    y, Ly, Jy = torch.empty_like(x), torch.empty_like(L), torch.empty_like(J)
    scratch = x.new_empty(B, SCRATCH, n, d)  # m1, m2, the sums Su1, Su2, Sav; Lq, Lk, Lv
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        code = lib.fl_block_launch(
            *(t.data_ptr() for t in (x, J, L, wq, wk, wv, wo, w1, b1, w2, b2, y, Jy, Ly,
                                     scratch)),
            B, K, n, d, num_heads, kc, _cuda.stream(),
        )
    _cuda.check(code, 'fl_block')
    psiformer_block_fl.launches += 1
    return y, Jy, Ly


def psiformer_block_fl(x, J, L, wq, wk, wv, wo, w1, b1, w2, b2, num_heads: int):
    """(y, J_y, L_y) of the PsiFormer layer: the CUDA kernel on the card, else plain."""
    if x.is_cuda:
        return _launch(x, J, L, wq, wk, wv, wo, w1, b1, w2, b2, num_heads)
    return psiformer_block_fl_plain(x, J, L, wq, wk, wv, wo, w1, b1, w2, b2, num_heads)


psiformer_block_fl.launches = 0
