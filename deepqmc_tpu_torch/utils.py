"""Helpers shared by the port's entry points, and its copies of the numeric
helpers of ``deepqmc_tpu/utils.py`` that the training step and the samplers
need (``log_squeeze``, ``triu_flat``, ``multinomial_resampling`` and the
learning-rate schedules; the masked and weighted means over the global walker
axis are in :mod:`.loss`), with the two tree helpers of the sampler states
(dicts of tensors and ``Psi`` tuples)."""

import contextlib
import logging
import os

import torch

__all__ = [
    'ConstantSchedule', 'InverseSchedule', 'active_levers', 'cuda_median_ms', 'flatten_dict',
    'grad_precision_ctx', 'log_squeeze', 'matmul_precision', 'multinomial_resampling',
    'resolve_device', 'sampling_precision_ctx', 'set_rows', 'set_true_fp32', 'split_dict',
    'tree_map', 'tree_norm', 'tree_stack', 'triu_flat',
]

log = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    ``None`` means ``cuda``; where CUDA is absent that raises instead of
    falling back to the CPU, so a caller who wants the CPU says so.
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


# --- matmul precision: the JAX package's labels on PyTorch's settings ---------
#
# 'highest' is true float32, 'high' TF32 (10 mantissa bits; the TPU's 'high' is
# 3-pass bf16, about 16), 'default' one bf16 pass (torch's 'medium'; refused
# where CUDA is present, as cuBLAS runs it as TF32).  The
# port's default for every switch is 'highest'; the JAX package's accelerator
# defaults were promoted by a LiH convergence A/B on a TPU, which does not
# carry over to this card (``ab_lih_convergence.py`` is the gate for it).
TORCH_PRECISION = {'highest': 'highest', 'high': 'high', 'default': 'medium'}


def _torch_precision(label: str, switch: str) -> str:
    if label not in TORCH_PRECISION:
        raise ValueError(
            f'{switch}={label!r}: want one of {sorted(TORCH_PRECISION)} or inherit'
        )
    if label == 'default' and torch.cuda.is_available():
        # measured on the H100 (chip_smoke.py, precision_path): a float32
        # product under 'medium' has TF32's error, not bf16's
        raise ValueError(
            f"{switch}='default': cuBLAS runs float32 products under torch's 'medium' "
            "as TF32, not in one bf16 pass, so the label would name a precision the "
            "card does not run; use 'high' (TF32) or 'highest'"
        )
    return TORCH_PRECISION[label]


@contextlib.contextmanager
def matmul_precision(label: str, switch: str = 'matmul precision'):
    """Float32 products at the JAX label ``label`` inside the block; saves and
    restores ``torch.get_float32_matmul_precision()`` and
    ``torch.backends.cuda.matmul.allow_tf32``, also on an exception.  Only the
    precision API is written (torch raises once it and ``allow_tf32`` disagree)."""
    saved, tf32 = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision(_torch_precision(label, switch))
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)
        if torch.backends.cuda.matmul.allow_tf32 != tf32:
            torch.backends.cuda.matmul.allow_tf32 = tf32


def _precision_ctx(switch: str):
    label = os.environ.get(switch, 'highest')
    if label == 'inherit':
        return contextlib.nullcontext()
    _torch_precision(label, switch)  # an unknown label raises here, not on entry
    return matmul_precision(label, switch)


def sampling_precision_ctx():
    """Matmul precision of the Metropolis and Langevin forwards, the psi refresh
    after a step and equilibration (``deepqmc_tpu/utils.py``
    ``sampling_precision_ctx``): ``DEEPQMC_TPU_SAMPLING_PRECISION`` =
    highest (the port's default), high, default (refused where CUDA is
    present) or inherit (the global pin untouched).  The forward Laplacian
    pins 'highest' inside it."""
    return _precision_ctx('DEEPQMC_TPU_SAMPLING_PRECISION')


def grad_precision_ctx():
    """Matmul precision of the pullback of log|psi| and of the KFAC taps
    (``deepqmc_tpu/utils.py`` ``grad_precision_ctx``):
    ``DEEPQMC_TPU_GRAD_PRECISION``, labels as :func:`sampling_precision_ctx`."""
    return _precision_ctx('DEEPQMC_TPU_GRAD_PRECISION')


def active_levers() -> dict:
    """The precision switches set below true float32, by name (the Jacobian
    contractions also where they follow a bf16 store by default)."""
    env = os.environ
    levers = {
        name: env[name]
        for name in ('DEEPQMC_TPU_MATMUL_PRECISION', 'DEEPQMC_TPU_SAMPLING_PRECISION',
                     'DEEPQMC_TPU_GRAD_PRECISION')
        if env.get(name, 'highest') not in ('highest', 'inherit')
    }
    from .fwdlap import jac_matmul_bf16, jac_store_dtype

    if jac_store_dtype() is not None:
        levers['DEEPQMC_TPU_JAC_DTYPE'] = 'bf16'
    if jac_matmul_bf16():
        levers['DEEPQMC_TPU_JAC_MATMUL'] = 'bf16'
    return levers


def set_true_fp32():
    """The global pin: float32 products at ``DEEPQMC_TPU_MATMUL_PRECISION``
    (default highest, true float32; the JAX package's pin of the same name),
    cuDNN's TF32 off.  Logs once which precision levers are on, if any."""
    label = os.environ.get('DEEPQMC_TPU_MATMUL_PRECISION', 'highest')
    torch.set_float32_matmul_precision(_torch_precision(label, 'DEEPQMC_TPU_MATMUL_PRECISION'))
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (the Jacobian contraction lever) accumulate in float32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    levers = active_levers()
    if levers and not set_true_fp32.logged:
        set_true_fp32.logged = True
        log.info('precision levers below true float32: %s',
                 ', '.join(f'{k}={v}' for k, v in levers.items()))


set_true_fp32.logged = False


def cuda_median_ms(fn, runs=20, warmup=3):
    """Median time of ``fn()`` on the card in ms, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def chunk_size(n: int, chunk=None, env: str = '', default: int = 0) -> int:
    """The largest divisor of ``n`` at most ``chunk`` (0: ``n``, no chunks);
    ``chunk`` None reads the environment variable ``env`` (``default`` where
    unset), as the JAX package reads its chunk settings."""
    if chunk is None:
        chunk = int(os.environ.get(env, str(default)))
    if not chunk:
        return n
    return max(d for d in range(1, min(chunk, n) + 1) if n % d == 0)


def triu_flat(x: torch.Tensor) -> torch.Tensor:
    """The entries above the diagonal of the last two axes, flat in row order."""
    i, j = torch.triu_indices(x.shape[-2], x.shape[-1], 1, device=x.device)
    return x[..., i, j]


def log_squeeze(x: torch.Tensor) -> torch.Tensor:
    """Soft, sign-preserving log-like squashing: the identity near 0, logarithmic far out."""
    sgn, x = torch.sign(x), x.abs()
    return sgn * torch.log1p((x + x**2 / 2 + x**3) / (1 + x**2))


def InverseSchedule(init_value, decay_rate):
    """lr(n) = init / (1 + n / decay)."""
    return lambda n: init_value / (1 + n / decay_rate)


def ConstantSchedule(value):
    return lambda n: value


def tree_norm(tensors) -> torch.Tensor:
    """The sum of the L2 norms of ``tensors`` (``deepqmc_tpu.utils.tree_norm``)."""
    return sum(torch.linalg.vector_norm(t) for t in tensors)


def multinomial_resampling(weights: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Walker indices drawn in proportion to ``weights`` ``[B]``, one per entry
    of ``uniforms`` (draws on [0, 1)), by inverting the normalised cumulative sum."""
    cum = torch.cumsum(weights, 0)
    cum = cum / cum[-1]
    return torch.searchsorted(cum, uniforms, right=True).clamp(0, len(weights) - 1)


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to trees of one structure: dicts and tuples
    (named ones such as ``Psi`` included) are nodes, anything else a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        leaves = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*leaves) if hasattr(tree, '_fields') else tuple(leaves)
    return fn(tree, *rest)


def tree_stack(trees):
    """Trees of one structure stacked leaf by leaf along a new leading axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def set_rows(full: torch.Tensor, idxs: list, rows) -> torch.Tensor:
    """A copy of ``full`` with ``full[idxs[j]] = rows[j]``; the indices are host
    integers, so no index tensor is copied to the device."""
    full = full.clone()
    for i, row in zip(idxs, rows):
        full[i] = row
    return full


def flatten_dict(dictionary: dict, parent_key: str = '', separator: str = '/') -> dict:
    """Nested dicts as one dict of ``separator``-joined keys."""
    items: list = []
    for key, value in dictionary.items():
        new_key = parent_key + separator + key if parent_key else key
        if isinstance(value, dict):
            items.extend(flatten_dict(value, new_key, separator=separator).items())
        else:
            items.append((new_key, value))
    return dict(items)


def split_dict(dictionary: dict, cond) -> tuple[dict, dict]:
    """(the entries whose key meets ``cond``, the others)."""
    return ({k: v for k, v in dictionary.items() if cond(k)},
            {k: v for k, v in dictionary.items() if not cond(k)})
