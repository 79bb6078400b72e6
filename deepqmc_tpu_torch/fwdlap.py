"""Forward Laplacian: explicit (value, Jacobian, Laplacian) propagation.

Counterpart of ``deepqmc_tpu/fwdlap.py``.  The JAX package traces ``log psi``
to a jaxpr and interprets it; here every module is written once against the
small op set of this file, and each op accepts either a plain tensor or an
:class:`FL` triple.  Given the electron coordinates as an :class:`FL` whose
Jacobian is the identity, the same module code yields

    (v,  J[k, ...] = d v / d x_k,  L[...] = sum_k d^2 v / d x_k^2)

for every intermediate, with ``x`` the flattened 3N coordinates (K = 3N).

Layout: the primal ``x`` is ``[B, *s]`` (walker-major), the Jacobian is
batch-major ``[B, K, *s]`` and the Laplacian is ``[B, *s]``.  Ops address
feature axes with negative dimensions only, so one call acts alike on all
three channels.  A plain tensor mixed into an op is a constant: with fewer
dimensions than the primal it broadcasts over the trailing axes; with as many
it is aligned with the primal, walker axis included.

The whole evaluation runs under ``torch.inference_mode()``: no autograd graph
is built over the ``[B, K, ...]`` Jacobians.

The fused rules (the attention core, the log-determinant traces and the
PsiFormer block) launch the hand-written kernels on the card.  Inside
:func:`use_plain_cores` they run the kernels' plain PyTorch versions on any
device: the forward-mode tangent pass of the force estimators (``force.py``)
asks for that explicitly, since a ``ctypes`` kernel carries no tangent and its
wrapper raises on one.

Two precision levers of the JAX package act on the Jacobians (read from the
environment once a pass, as :func:`jac_levers` says): ``DEEPQMC_TPU_JAC_DTYPE=
bf16`` stores every Jacobian in bfloat16 between ops (each op's arithmetic
still runs in the primal's dtype: an op reads :attr:`FL.jac` upcast, and the
kernel-backed rules read :attr:`FL.stored_jac` as stored), and
``DEEPQMC_TPU_JAC_MATMUL=bf16`` (by default on with a bf16 store) contracts
the Jacobian side of a product with both operands in bfloat16 and float32
accumulation.  The primal and the Laplacian never drop precision.  The port's
default is neither, on the CPU and on the card.
"""

import contextlib
import contextvars
import os
from collections.abc import Sequence
from typing import NamedTuple, Optional

import torch

from .utils import matmul_precision

__all__ = ['FL', 'Levers', 'is_fl', 'jac_levers', 'use_plain_cores']

_PLAIN_CORES = contextvars.ContextVar('plain_cores', default=False)


class Levers(NamedTuple):
    """The Jacobian levers of a pass: the store dtype (None: the primal's) and
    whether Jacobian contractions run in bfloat16."""

    store: Optional[torch.dtype] = None
    bf16_matmul: bool = False


_LEVERS = contextvars.ContextVar('jac_levers', default=Levers())


def jac_store_dtype() -> Optional[torch.dtype]:
    """``DEEPQMC_TPU_JAC_DTYPE``: bf16 (or bfloat16) stores the Jacobians in
    bfloat16; f32, float32, native, off, highest or unset keep the primal's
    dtype (``deepqmc_tpu/fwdlap.py`` ``_jac_store_dtype``, whose accelerator
    default is bf16; the port's is the compute dtype everywhere)."""
    name = os.environ.get('DEEPQMC_TPU_JAC_DTYPE', '').lower()
    return torch.bfloat16 if name in ('bf16', 'bfloat16') else None


def jac_matmul_bf16() -> bool:
    """``DEEPQMC_TPU_JAC_MATMUL``: bf16 (or bfloat16) on, f32, float32,
    native, off or highest off; unset follows the store
    (``deepqmc_tpu/fwdlap.py`` ``_jac_matmul_bf16``)."""
    name = os.environ.get('DEEPQMC_TPU_JAC_MATMUL', '').lower()
    if name in ('bf16', 'bfloat16'):
        return True
    if name in ('f32', 'float32', 'native', 'off', 'highest'):
        return False
    return jac_store_dtype() is not None


@contextlib.contextmanager
def jac_levers(levers: Optional[Levers] = None):
    """Within the block, FL values take ``levers`` (by default as the
    environment says); :func:`forward_laplacian` enters it for each pass."""
    if levers is None:
        levers = Levers(jac_store_dtype(), jac_matmul_bf16())
    token = _LEVERS.set(levers)
    try:
        yield
    finally:
        _LEVERS.reset(token)


def levers() -> Levers:
    """The Jacobian levers in force here."""
    return _LEVERS.get()


@contextlib.contextmanager
def use_plain_cores():
    """Within the block, every fused rule runs its kernel's plain PyTorch
    version, whatever the tensors' device."""
    token = _PLAIN_CORES.set(True)
    try:
        yield
    finally:
        _PLAIN_CORES.reset(token)


def uses_plain_cores() -> bool:
    """Whether the fused rules run their plain versions here (:func:`use_plain_cores`)."""
    return _PLAIN_CORES.get()


def is_fl(v) -> bool:
    return isinstance(v, FL)


def _neg(dim: int) -> int:
    if dim >= 0:
        raise ValueError(f'FL ops address feature axes from the end, got dim={dim}')
    return dim


def _for_jac(c, xdim: int):
    """A constant aligned with a primal of ``xdim`` dims, reshaped for the jac."""
    if not torch.is_tensor(c) or c.dim() < xdim:
        return c
    if c.dim() > xdim:
        raise ValueError('constant has more dims than the FL primal')
    return c.unsqueeze(1)


def bf16_jac_contraction(v: 'FL') -> bool:
    """Whether a contraction of ``v``'s Jacobian runs with bfloat16 operands:
    the contraction lever is on and the Jacobian is stored in bfloat16, as
    ``deepqmc_tpu/fwdlap.py`` ``_dot_general_rule`` decides."""
    return _LEVERS.get().bf16_matmul and v.stored_jac.dtype == torch.bfloat16


class FL:
    """A value with its Jacobian ``[B, K, *s]`` and Laplacian ``[B, *s]``."""

    __slots__ = ('x', 'stored_jac', 'lap')

    def __init__(self, x: torch.Tensor, jac: torch.Tensor, lap: torch.Tensor):
        store = _LEVERS.get().store
        if store is not None and jac.dtype != store and jac.is_floating_point():
            jac = jac.to(store)
        self.x, self.stored_jac, self.lap = x, jac, lap

    @property
    def jac(self) -> torch.Tensor:
        """The Jacobian in the primal's dtype (upcast where it is stored lower)."""
        jac = self.stored_jac
        return jac if jac.dtype == self.x.dtype else jac.to(self.x.dtype)

    @classmethod
    def seed(cls, x: torch.Tensor) -> 'FL':
        """The input ``[B, *s]``: identity Jacobian over its K = prod(s) entries."""
        B, shape = x.shape[0], x.shape[1:]
        K = x[0].numel()
        eye = torch.eye(K, dtype=x.dtype, device=x.device).reshape(K, *shape)
        return cls(x, eye.expand(B, K, *shape), torch.zeros_like(x))

    # --- metadata -------------------------------------------------------------

    @property
    def shape(self):
        return self.x.shape

    def dim(self) -> int:
        return self.x.dim()

    @property
    def ndim(self) -> int:
        return self.x.dim()

    @property
    def dtype(self):
        return self.x.dtype

    def _full(self, shape):
        """The triple broadcast to the primal ``shape`` (views, no copies)."""
        B, K = self.stored_jac.shape[:2]
        return FL(
            self.x.expand(shape),
            self.stored_jac.expand(B, K, *shape[1:]),
            self.lap.expand(shape),
        )

    # --- arithmetic -----------------------------------------------------------

    def __add__(self, other):
        return add(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return add(self, neg(other))

    def __neg__(self):
        return neg(self)

    def __mul__(self, other):
        return mul(self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return div(self, other)

    def __rtruediv__(self, other):
        return div(other, self)

    def __pow__(self, p):
        return pow(self, p)

    def __matmul__(self, w: torch.Tensor):
        """Right product with a constant matrix (a dense layer's weight); the
        Jacobian side in bfloat16 where :func:`bf16_jac_contraction` says."""
        if is_fl(w) or w.dim() != 2:
            raise ValueError('FL @ w takes a constant 2-D w')
        if bf16_jac_contraction(self):
            # one bf16 GEMM with float32 accumulation; torch rounds its output
            # to bfloat16, as the store would round JAX's float32 one
            jac = self.stored_jac @ w.to(torch.bfloat16)
        else:
            jac = self.jac @ w
        return FL(self.x @ w, jac, self.lap @ w)

    # --- structure ------------------------------------------------------------

    def __getitem__(self, idx):
        """Feature-axis indexing after a leading ``...``: slices, ``None`` and
        integer index tensors (a gather, such as the off-diagonal senders of
        ``gnn.graph``), applied alike to the three channels."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        if idx[0] is not Ellipsis:
            raise IndexError('FL indexing must start with ... (feature axes only)')
        return FL(self.x[idx], self.stored_jac[idx], self.lap[idx])

    def sum(self, dim: int, keepdim: bool = False) -> 'FL':
        dim = _neg(dim)
        return FL(
            self.x.sum(dim, keepdim), self.jac.sum(dim, keepdim), self.lap.sum(dim, keepdim)
        )

    def mean(self, dim: int, keepdim: bool = False) -> 'FL':
        dim = _neg(dim)
        return FL(
            self.x.mean(dim, keepdim), self.jac.mean(dim, keepdim), self.lap.mean(dim, keepdim)
        )

    def squeeze(self, dim: int) -> 'FL':
        dim = _neg(dim)
        return FL(self.x.squeeze(dim), self.stored_jac.squeeze(dim), self.lap.squeeze(dim))

    def transpose(self, dim0: int, dim1: int) -> 'FL':
        d0, d1 = _neg(dim0), _neg(dim1)
        return FL(self.x.transpose(d0, d1), self.stored_jac.transpose(d0, d1),
                  self.lap.transpose(d0, d1))

    def flatten(self, start_dim: int, end_dim: int = -1) -> 'FL':
        s, e = _neg(start_dim), _neg(end_dim)
        return FL(self.x.flatten(s, e), self.stored_jac.flatten(s, e), self.lap.flatten(s, e))

    def unflatten(self, dim: int, sizes: Sequence[int]) -> 'FL':
        dim = _neg(dim)
        return FL(
            self.x.unflatten(dim, sizes),
            self.stored_jac.unflatten(dim, sizes),
            self.lap.unflatten(dim, sizes),
        )


# --- elementwise and binary rules -------------------------------------------


def neg(v):
    return FL(-v.x, -v.stored_jac, -v.lap) if is_fl(v) else -v


def add(a, b):
    if not is_fl(a) and not is_fl(b):
        return a + b
    if not is_fl(a):
        a, b = b, a
    if not is_fl(b):
        y = a.x + b
        full = a._full(y.shape)
        return FL(y, full.jac, full.lap)
    _same_rank(a, b)
    y = a.x + b.x
    B, K = a.stored_jac.shape[:2]
    return FL(y, (a.jac + b.jac).expand(B, K, *y.shape[1:]), (a.lap + b.lap).expand(y.shape))


def mul(a, b):
    if not is_fl(a) and not is_fl(b):
        return a * b
    if not is_fl(a):
        a, b = b, a
    if not is_fl(b):
        return FL(a.x * b, a.jac * _for_jac(b, a.ndim), a.lap * b)
    _same_rank(a, b)
    return FL(
        a.x * b.x,
        a.jac * b.x.unsqueeze(1) + a.x.unsqueeze(1) * b.jac,
        a.lap * b.x + a.x * b.lap + 2 * (a.jac * b.jac).sum(1),
    )


def div(a, b):
    if not is_fl(a) and not is_fl(b):
        return a / b
    if not is_fl(b):
        return mul(a, 1 / b)
    y = (a.x if is_fl(a) else a) / b.x
    inv = 1 / b.x
    jb = b.jac
    yk, invk = y.unsqueeze(1), inv.unsqueeze(1)
    jac = -yk * jb * invk
    lap = -y * b.lap * inv + 2 * y * inv**2 * (jb * jb).sum(1)
    if is_fl(a):
        _same_rank(a, b)
        jac = jac + a.jac * invk
        lap = lap + a.lap * inv - 2 * inv**2 * (a.jac * jb).sum(1)
    return FL(y, jac, lap)


def _same_rank(a: FL, b: FL):
    if a.ndim != b.ndim:
        raise ValueError(f'FL operands of different rank: {a.shape} vs {b.shape}')


def _elementwise(v: FL, y, d1, d2) -> FL:
    """Chain rule for y = f(x) elementwise, given f' and f'' at x."""
    return FL(y, d1.unsqueeze(1) * v.jac, d1 * v.lap + d2 * (v.jac * v.jac).sum(1))


def exp(v):
    if not is_fl(v):
        return torch.exp(v)
    y = torch.exp(v.x)
    return _elementwise(v, y, y, y)


def tanh(v):
    if not is_fl(v):
        return torch.tanh(v)
    y = torch.tanh(v.x)
    d1 = 1 - y * y
    return _elementwise(v, y, d1, -2 * y * d1)


def _softplus(x):
    # log(1 + e^x) without overflow, exact for large x (jax.nn.softplus)
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def softplus(v):
    """log(1 + e^x), with f' = sigmoid(x) and f'' = sigmoid(x) (1 - sigmoid(x))."""
    if not is_fl(v):
        return _softplus(v)
    s = torch.sigmoid(v.x)
    return _elementwise(v, _softplus(v.x), s, s * (1 - s))


def sigmoid(v):
    if not is_fl(v):
        return torch.sigmoid(v)
    y = torch.sigmoid(v.x)
    d1 = y * (1 - y)
    return _elementwise(v, y, d1, d1 * (1 - 2 * y))


def silu(v):
    """x sigmoid(x), with f' = s (1 + x (1 - s)) and f'' = s (1 - s) (2 + x (1 - 2 s))."""
    if not is_fl(v):
        return v * torch.sigmoid(v)
    x = v.x
    s = torch.sigmoid(x)
    return _elementwise(v, x * s, s * (1 + x * (1 - s)), s * (1 - s) * (2 + x * (1 - 2 * s)))


def amin(v, dim: int):
    """The minimum over the feature axis ``dim``: each channel taken where the
    primal is least."""
    if not is_fl(v):
        return v.amin(dim)
    dim = _neg(dim)
    idx = v.x.argmin(dim, keepdim=True)
    jdx = idx.unsqueeze(1).expand(idx.shape[0], v.stored_jac.shape[1], *idx.shape[1:])
    return FL(v.x.gather(dim, idx), v.stored_jac.gather(dim, jdx),
              v.lap.gather(dim, idx)).squeeze(dim)


def log(v):
    if not is_fl(v):
        return torch.log(v)
    inv = 1 / v.x
    return _elementwise(v, torch.log(v.x), inv, -inv * inv)


def log1p(v):
    if not is_fl(v):
        return torch.log1p(v)
    inv = 1 / (1 + v.x)
    return _elementwise(v, torch.log1p(v.x), inv, -inv * inv)


def sqrt(v):
    if not is_fl(v):
        return torch.sqrt(v)
    y = torch.sqrt(v.x)
    return _elementwise(v, y, 0.5 / y, -0.25 / (y * v.x))


def abs(v):  # noqa: A001 - mirrors torch.abs
    if not is_fl(v):
        return torch.abs(v)
    s = torch.sign(v.x)
    return FL(torch.abs(v.x), s.unsqueeze(1) * v.jac, s * v.lap)


def pow(v, p: float):  # noqa: A001 - mirrors torch.pow
    """``v ** p`` for a constant scalar exponent."""
    if not is_fl(v):
        return v**p
    return _elementwise(v, v.x**p, p * v.x ** (p - 1), p * (p - 1) * v.x ** (p - 2))


def cat(values: Sequence, dim: int):
    """Concatenate along a feature axis; lower-rank constants are broadcast over
    the walker axis and, next to FL values, get zero derivatives."""
    dim = _neg(dim)
    ref = max(values, key=lambda v: v.dim())
    B = ref.shape[0]

    def batched(v):
        if v.dim() == ref.dim():
            return v
        if v.dim() != ref.dim() - 1:
            raise ValueError("cat: a constant may lack the walker axis only")
        return v.expand(B, *v.shape)

    fls = [v for v in values if is_fl(v)]
    if not fls:
        return torch.cat([batched(v) for v in values], dim)
    K = fls[0].stored_jac.shape[1]

    def full(v):
        if is_fl(v):
            return v
        x = batched(v)
        zeros = x.new_zeros(())
        return FL(x, zeros.expand(B, K, *x.shape[1:]), zeros.expand(x.shape))

    parts = [full(v) for v in values]
    return FL(
        torch.cat([p.x for p in parts], dim),
        torch.cat([p.jac for p in parts], dim),
        torch.cat([p.lap for p in parts], dim),
    )


def tile(v, dim: int, n: int):
    """Repeat the size-1 feature axis ``dim`` ``n`` times (``jnp.tile`` of a
    kept reduction), as a broadcast view of each channel."""
    dim = _neg(dim)

    def expand(t):
        shape = list(t.shape)
        shape[dim] = n
        return t.expand(shape)

    return FL(expand(v.x), expand(v.stored_jac), expand(v.lap)) if is_fl(v) else expand(v)


def dot(v, w: torch.Tensor, dim: int = -1):
    """The contraction ``(v * w).sum(dim)`` of ``v`` with a constant ``w``
    (broadcast against the primal), a ``jnp.einsum`` in the JAX package: on
    the Jacobian side ``w`` is rounded to bfloat16 where
    :func:`bf16_jac_contraction` says (the products of two bf16 values are
    exact in the primal's dtype, which accumulates them)."""
    if not is_fl(v):
        return (v * w).sum(dim)
    dim = _neg(dim)
    wj = _for_jac(w, v.ndim)
    if bf16_jac_contraction(v):
        from .ops.fl_attention import round_bf16

        wj = round_bf16(wj)
    return FL((v.x * w).sum(dim), (v.jac * wj).sum(dim), (v.lap * w).sum(dim))


def primal(v) -> torch.Tensor:
    """The value channel of an FL, or the tensor itself."""
    return v.x if is_fl(v) else v


# --- fused rules (kernel-backed) ---------------------------------------------


def mha_core(q2, k2, v2, num_heads: int, core=None, mask=None):
    """softmax(q k^T / sqrt(dh)) v on head-flat ``[B, n, H*dh]`` operands.

    Counterpart of ``nn/modules.py`` ``_mha_core_flat`` and of the
    attention-core rule ``fwdlap._mha_core_flat_rule``: on FL operands the
    whole core goes through ``core`` on per-head operands, by default
    :func:`ops.fl_attention.mha_core_fl` (the CUDA kernel on the card).  The
    head split is a view of the flat layout.  With a boolean ``mask``
    ``[n, n]`` (query, key) the keys where it is False are left out, as the
    JAX package's masked branch does per primitive: the core is then the
    kernel's plain version with the mask, on any device.
    """
    if not any(is_fl(v) for v in (q2, k2, v2)):
        q, k, v = (t.unflatten(-1, (num_heads, -1)) for t in (q2, k2, v2))
        logits = torch.einsum('bihd,bjhd->bhij', q, k) / q.shape[-1] ** 0.5
        if mask is not None:
            logits = torch.where(mask, logits, -1e30)
        att = torch.einsum('bhij,bjhd->bihd', torch.softmax(logits, -1), v)
        return att.flatten(-2)
    if not all(is_fl(v) for v in (q2, k2, v2)):
        raise ValueError('mha_core: q, k and v must all be FL or all be tensors')
    from functools import partial

    if mask is not None:
        # the JAX package's masked branch is per primitive: its products
        # follow the contraction rule of ``_dot_general_rule``
        from .ops.fl_attention import mha_core_fl_plain

        low = bf16_jac_contraction(q2)
        core = partial(mha_core_fl_plain, mask=mask)
    elif core is None:
        from .ops.fl_attention import mha_core_fl, mha_core_fl_plain

        # the kernel's bf16 Jacobian contractions (``_jac_bmm_low``)
        low = _LEVERS.get().bf16_matmul and q2.dtype == torch.float32
        core = mha_core_fl_plain if uses_plain_cores() else mha_core_fl
    else:
        low = False
    if low:  # the core's low mode; a core is called as before without it
        core = partial(core, low=True)

    def heads(t):
        return t.unflatten(-1, (num_heads, -1))

    qkv = (q2, k2, v2)
    t, jt, lt = core(
        *(heads(v.x) for v in qkv), *(heads(v.stored_jac) for v in qkv),
        *(heads(v.lap) for v in qkv),
    )
    return FL(t.flatten(-2), jt.flatten(-2), lt.flatten(-2))


def slogdet_flat_rows(up, down, n_det: int):
    """Per-determinant (sign, log|det|) of the row concatenation [up; down].

    Counterpart of ``_determinant_mix``'s row concatenation followed by
    ``slogdet_flat`` and of the rule ``fwdlap._slogdet_flat_rule`` on
    ``FLRowBlocks``: the primal and Laplacian are concatenated, the Jacobian
    stays in its two row blocks, which the kernel reads in place.
    """
    from .ops.fl_slogdet import slogdet_fl_flat_split
    from .ops.slogdet import slogdet_flat

    if not is_fl(up) and not is_fl(down):
        return slogdet_flat(torch.cat([up, down], dim=-2), n_det)
    if not (is_fl(up) and is_fl(down)):
        raise ValueError('slogdet_flat_rows: both row blocks must be FL')
    sign, logdet, jout, lout = slogdet_fl_flat_split(
        torch.cat([up.x, down.x], dim=-2),
        up.stored_jac.contiguous(),
        down.stored_jac.contiguous(),
        torch.cat([up.lap, down.lap], dim=-2),
        n_det,
        plain=uses_plain_cores(),
    )
    return sign, FL(logdet, jout, lout)


def slogdet_flat(v, n_det: int):
    """Per-determinant (sign, log|det|) of a flat orbital matrix ``[B, n, n_det*n]``.

    Counterpart of ``ops/slogdet.py`` ``slogdet_flat`` and of the whole-Jacobian
    branch of ``fwdlap._slogdet_flat_rule`` (``slogdet_fl_flat_tpu``): the rows
    are split at nu = ceil(n/2) and the flat kernel takes the two blocks.
    """
    from .ops.fl_slogdet import slogdet_fl_flat_split
    from .ops.slogdet import slogdet_flat as slogdet_flat_op

    if not is_fl(v):
        return slogdet_flat_op(v, n_det)
    nu = (v.shape[-2] + 1) // 2
    sign, logdet, jout, lout = slogdet_fl_flat_split(
        v.x, v.stored_jac[..., :nu, :].contiguous(), v.stored_jac[..., nu:, :].contiguous(),
        v.lap, n_det,
        plain=uses_plain_cores(),
    )
    return sign, FL(logdet, jout, lout)


def _square_blocks(*vs):
    """Square-matrix row blocks as ``[B, D, rows, n]`` FLs, a ``[B, rows, n]``
    block taken as D = 1; and whether that axis was added."""
    if all(v.ndim == 3 for v in vs):
        return [v[..., None, :, :] for v in vs], True
    if all(v.ndim == 4 for v in vs):
        return list(vs), False
    raise ValueError(f'square slogdet takes [B, D, n, n] or [B, n, n], got {[v.shape for v in vs]}')


def _logdet_fl(sign, logdet, jout, lout, added_axis: bool):
    out = FL(logdet, jout, lout)
    return (sign[..., 0], out[..., 0]) if added_axis else (sign, out)


def slogdet(v):
    """(sign, log|det|) of square matrices ``[B, D, n, n]`` or ``[B, n, n]``.

    Counterpart of ``ops/slogdet.py`` ``slogdet`` and its rule
    ``fwdlap._slogdet_rule`` on a whole Jacobian ``[B, K, D, n, n]``: the
    traces go to :func:`ops.fl_slogdet.square_traces` (the CUDA kernel on the
    card).  ``slogdet(cat([up, down], -2))`` is the unsplit path that the JAX
    package selects with ``DEEPQMC_TPU_NO_SPLIT_SLOGDET``.
    """
    from .ops.fl_slogdet import slogdet_fl_square
    from .ops.slogdet import slogdet as slogdet_op

    if not is_fl(v):
        return slogdet_op(v)
    (v,), added = _square_blocks(v)
    out = slogdet_fl_square(v.x, v.stored_jac.contiguous(), v.lap.contiguous())
    return _logdet_fl(*out, added)


def slogdet_rows(up, down):
    """(sign, log|det|) of the row concatenation ``[up; down]`` of square row
    blocks ``[B, D, nu, n]`` and ``[B, D, nd, n]`` (or without D).

    Counterpart of a row concatenation followed by ``slogdet`` under
    ``fwdlap._slogdet_rule`` on ``FLRowBlocks``: the Jacobian stays in its two
    row blocks, which :func:`ops.fl_slogdet.square_split_traces` reads in place.
    nd may be 0.
    """
    from .ops.fl_slogdet import slogdet_fl_square_split

    if not is_fl(up) and not is_fl(down):
        return slogdet(torch.cat([up, down], dim=-2))
    if not (is_fl(up) and is_fl(down)):
        raise ValueError('slogdet_rows: both row blocks must be FL')
    (up, down), added = _square_blocks(up, down)
    out = slogdet_fl_square_split(
        torch.cat([up.x, down.x], dim=-2),
        up.stored_jac.contiguous(),
        down.stored_jac.contiguous(),
        torch.cat([up.lap, down.lap], dim=-2),
    )
    return _logdet_fl(*out, added)


def forward_laplacian(f):
    """LaplacianFactory: ``f`` maps electrons ``[B, n, 3]`` to ``log psi`` ``[B]``;
    returns ``r -> (lap f(r) [B], grad f(r) [B, 3n])`` in one forward pass.

    The pass takes the Jacobian levers of the environment (:func:`jac_levers`)
    and runs its float32 products at 'highest' whatever the context (the
    sampling and gradient contexts never reach the local energy); the
    gradient comes back in the primal's dtype."""

    def lap(r: torch.Tensor):
        with jac_levers(), matmul_precision('highest'):
            out = f(FL.seed(r))
            return out.lap, out.jac

    return lap
