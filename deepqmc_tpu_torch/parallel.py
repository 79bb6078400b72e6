"""The parallel runtime: walker shards over processes, one process per GPU,
and the reductions over the global walker axis (counterpart of
``deepqmc_tpu/parallel.py``).

The JAX package keeps walkers as global arrays sharded over a device mesh
and lets XLA insert the collectives.  Here each process holds its shard of
the walker axis (axis 2 of ``[mol, state, walker, ...]``), the parameters
are replicated (broadcast from rank 0), and every statistic over the walkers
goes through the ``all_device_*`` helpers, which reduce across the processes
of the default ``torch.distributed`` group.  Without a group each is the
plain reduction over the local batch; a group of one runs the collectives,
whose results are then the local ones.

The sums behind the means carry an identity backward: the loss the gradient
estimator differentiates is the same on every rank, so the cotangent of each
rank's local part is the cotangent of the global sum.  The medians and
quantiles are exact: the ``B`` numbers of the walker axis are gathered (as an
``all_reduce`` of a zero-padded buffer, which NCCL and gloo both take on CUDA
tensors) and interpolated linearly between the two nearest order statistics,
as ``jnp.median`` and ``jnp.quantile`` do (``torch.median`` would return the
lower middle value of an even batch).

A collective that fails raises; no rank carries on alone.
"""

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    'all_device_max', 'all_device_mean', 'all_device_median', 'all_device_min',
    'all_device_quantile', 'all_device_std', 'all_device_sum', 'any_rank', 'claim_device',
    'gather_on_host', 'get_process_count', 'get_process_index', 'init_args_from_env',
    'local_device', 'maybe_init_multi_host', 'pexp_normalize_mean', 'replicate_on_devices',
    'shard_walkers', 'sum_over_ranks',
]

WALKER_AXIS = 2


def _distributed() -> bool:
    """Whether a process group is formed: its collectives run even for one
    rank (as the identity), so a group of one takes the same code path."""
    return dist.is_available() and dist.is_initialized()


def get_process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def init_args_from_env(environ=None) -> Optional[dict]:
    """The arguments of :func:`maybe_init_multi_host` that the environment
    gives, or None where multi-process runs are not asked for
    (``DEEPQMC_TPU_MULTIHOST`` unset).  The coordinator comes from
    ``DEEPQMC_TPU_COORDINATOR_ADDRESS``, ``DEEPQMC_TPU_NUM_PROCESSES`` and
    ``DEEPQMC_TPU_PROCESS_ID``; under SLURM from ``SLURM_PROCID``,
    ``SLURM_NTASKS`` and ``SLURM_LOCALID`` (the task's index on its node),
    with the coordinator at ``DEEPQMC_TPU_COORDINATOR_ADDRESS`` or the first
    node of ``SLURM_JOB_NODELIST`` (a plain host name), port 29500.
    ``local_rank`` is None where the environment does not say it
    (:func:`local_device` then takes the rank)."""
    env = os.environ if environ is None else environ
    if env.get('DEEPQMC_TPU_MULTIHOST', '').lower() not in ('1', 'true'):
        return None
    address = env.get('DEEPQMC_TPU_COORDINATOR_ADDRESS')
    local = env.get('SLURM_LOCALID')
    local_rank = None if local is None else int(local)
    if 'SLURM_PROCID' in env and 'DEEPQMC_TPU_PROCESS_ID' not in env:
        if not address:
            first = env.get('SLURM_JOB_NODELIST', 'localhost').split(',')[0]
            if '[' in first:  # host[01-04]: the first of the range
                stem, rest = first.split('[', 1)
                first = stem + rest.split('-')[0].split(',')[0].rstrip(']')
            address = f'{first}:29500'
        return dict(address=address, world_size=int(env['SLURM_NTASKS']),
                    rank=int(env['SLURM_PROCID']), local_rank=local_rank)
    if not address:
        raise ValueError('DEEPQMC_TPU_MULTIHOST needs DEEPQMC_TPU_COORDINATOR_ADDRESS, '
                         'DEEPQMC_TPU_NUM_PROCESSES and DEEPQMC_TPU_PROCESS_ID, or a SLURM task')
    return dict(address=address, world_size=int(env['DEEPQMC_TPU_NUM_PROCESSES']),
                rank=int(env['DEEPQMC_TPU_PROCESS_ID']), local_rank=local_rank)


def local_device(rank: int, local_rank: Optional[int], device_count: int) -> int:
    """The index of this process's GPU among the ``device_count`` it sees:
    0 where it sees one (its own card, as ``CUDA_VISIBLE_DEVICES`` or SLURM's
    GPU binding leave it), else its node-local rank, which is the rank modulo
    ``device_count`` where the environment does not give it (one process per
    GPU, ranks filling a node in order).  A local rank beyond the GPUs raises."""
    if device_count < 1:
        raise RuntimeError('a CUDA process group needs a GPU, and this process sees none')
    if device_count == 1:
        return 0
    local = rank % device_count if local_rank is None else local_rank
    if local >= device_count:
        raise ValueError(f'node-local rank {local} has no GPU of its own: this process sees '
                         f'{device_count}')
    return local


def claim_device(store, rank: int, world_size: int, device_id: str):
    """Publish this rank's GPU (``device_id``, unique per card) in ``store``
    and raise where another rank holds the same card: NCCL takes one rank a
    GPU."""
    store.set(f'deepqmc_tpu/gpu/{rank}', device_id)
    held = [store.get(f'deepqmc_tpu/gpu/{r}').decode() for r in range(world_size)]
    shared = [r for r, d in enumerate(held) if d == device_id and r != rank]
    if shared:
        raise RuntimeError(f'ranks {sorted([rank, *shared])} share the GPU {device_id}: NCCL '
                           'takes one process a GPU')


def _device_id(index: int) -> str:
    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, 'uuid', None)
    if uuid is not None:
        return str(uuid)
    visible = os.environ.get('CUDA_VISIBLE_DEVICES', '')
    return f'{socket.gethostname()}:{visible}:{index}'


def maybe_init_multi_host(device=None, environ=None, backend=None) -> bool:
    """Join the process group the environment describes (:func:`init_args_from_env`);
    True where one was formed.  The backend is ``backend``, by default
    ``nccl`` on CUDA and ``gloo`` on the CPU.  On CUDA each process takes the
    GPU of :func:`local_device`, and under NCCL two ranks on one GPU raise
    (:func:`claim_device`).  A group that does not form raises."""
    args = init_args_from_env(environ)
    if args is None or (dist.is_available() and dist.is_initialized()):
        return False
    device = torch.device(device or 'cuda')
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    host, port = args['address'].rsplit(':', 1)
    rank, world_size = args['rank'], args['world_size']
    store = dist.TCPStore(host, int(port), world_size, is_master=rank == 0)
    if device.type == 'cuda':
        index = local_device(rank, args['local_rank'], torch.cuda.device_count())
        torch.cuda.set_device(index)
        if backend == 'nccl':
            claim_device(store, rank, world_size, _device_id(index))
    dist.init_process_group(backend, store=store, world_size=world_size, rank=rank)
    return True


def _collective_device() -> torch.device:
    """Where a collective's own buffer lives: the current GPU under NCCL, else the CPU."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def any_rank(flag) -> bool:
    """Whether ``flag`` holds on any rank (every rank gets the same answer)."""
    if not _distributed():
        return bool(flag)
    t = torch.tensor([float(bool(flag))], device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def shard_walkers(tree, walker_axis: int = WALKER_AXIS):
    """This rank's slice of every leaf's ``walker_axis`` (a dict, list or
    tuple of tensors); a leaf without that axis, or one it does not divide
    evenly, stays whole, as the JAX package replicates it."""
    from .utils import tree_map

    n, rank = get_process_count(), get_process_index()

    def take(x):
        if not isinstance(x, torch.Tensor) or x.dim() <= walker_axis or x.shape[walker_axis] % n:
            return x
        size = x.shape[walker_axis] // n
        return x.narrow(walker_axis, rank * size, size).clone()

    return tree if n == 1 else tree_map(take, tree)


def replicate_on_devices(tree, src: int = 0):
    """A module's parameters and buffers set to rank ``src``'s in place (the
    module returned), or a tree of tensors with rank ``src``'s values."""
    from .utils import tree_map

    if not _distributed():
        return tree
    with torch.no_grad():
        if isinstance(tree, torch.nn.Module):
            for t in [*tree.parameters(), *tree.buffers()]:
                dist.broadcast(t.data, src)
            return tree

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.clone()
        dist.broadcast(x, src)
        return x

    return tree_map(bcast, tree)


def _gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order: an
    ``all_reduce`` of a zero-padded ``[world, *x.shape]`` buffer."""
    n = get_process_count()
    buf = x.new_zeros(n, *x.shape)
    buf[get_process_index()] = x
    dist.all_reduce(buf)
    return torch.cat(list(buf.unbind(0)), dim)


def gather_on_host(tree, walker_axis: int = WALKER_AXIS):
    """Host copies (numpy) of a tree's tensors, each leaf with a walker axis
    gathered from every rank along it."""
    import numpy as np

    from .utils import tree_map

    def get(x):
        if not isinstance(x, torch.Tensor):
            return x
        if _distributed() and x.dim() > walker_axis:
            x = _gather(x.detach(), walker_axis)
        return np.asarray(x.detach().cpu())

    return tree_map(get, tree)


def _leaves(tree, out: list):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _rebuild(tree, new: dict):
    if isinstance(tree, dict):
        return {k: _rebuild(v, new) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, new) for v in tree)
    return new.get(id(tree), tree) if isinstance(tree, torch.Tensor) else tree


def sum_over_ranks(tree):
    """A tree (dicts, lists, tuples) of tensors with each tensor summed over
    the ranks: one ``all_reduce`` of the leaves flattened together per dtype
    and device.  Every rank gets the same result."""
    if not _distributed():
        return tree
    groups: dict = {}
    for t in _leaves(tree, []):
        groups.setdefault((t.dtype, t.device), []).append(t)
    new = {}
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.all_reduce(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            new[id(t)] = part.view(t.shape)
    return _rebuild(tree, new)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose backward passes the cotangent through
    (the differentiated loss is replicated, so that is the chain rule)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g


def all_device_sum(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The sum of ``x`` over ``dim`` (all of it for None) and over the ranks."""
    s = x.sum() if dim is None else x.sum(dim, keepdim=keepdim)
    return _AllReduceSum.apply(s) if _distributed() else s


def _count(x: torch.Tensor, dim) -> int:
    """The global number of entries a mean over ``dim`` takes."""
    if dim is None:
        local = x.numel()
    else:
        dims = (dim,) if isinstance(dim, int) else tuple(dim)
        local = 1
        for d in dims:
            local *= x.shape[d]
    return local * get_process_count()


def all_device_mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The mean over ``dim`` (all of it for None) of the global batch."""
    if not _distributed():
        return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
    return all_device_sum(x, dim, keepdim) / _count(x, dim)


def all_device_std(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The population standard deviation over ``dim`` of the global batch."""
    if not _distributed():
        return (x.std(correction=0) if dim is None
                else x.std(dim, correction=0, keepdim=keepdim))
    mean = all_device_mean(x, dim, keepdim=True)
    return torch.sqrt(all_device_mean((x - mean) ** 2, dim, keepdim))


def _extreme(x, dim, keepdim, op, local):
    out = local(x) if dim is None else local(x, dim, keepdim=keepdim)
    if _distributed():
        out = out.clone()
        dist.all_reduce(out, op=op)
    return out


def all_device_min(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    return _extreme(x, dim, keepdim, dist.ReduceOp.MIN, torch.amin)


def all_device_max(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    return _extreme(x, dim, keepdim, dist.ReduceOp.MAX, torch.amax)


def all_device_quantile(x: torch.Tensor, q, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The ``q``-th quantile over ``dim`` (all of it for None) of the global
    batch, by linear interpolation (``jnp.quantile``'s default)."""
    if _distributed():
        x = _gather(x.reshape(-1) if dim is None else x, 0 if dim is None else dim)
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if dim is None:
        return torch.quantile(x, q, interpolation='linear')
    return torch.quantile(x, q, dim=dim, keepdim=keepdim, interpolation='linear')


def all_device_median(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    return all_device_quantile(x, 0.5, dim, keepdim)


def pexp_normalize_mean(log_w: torch.Tensor, dim=None) -> torch.Tensor:
    """``exp(log_w)`` normalised to unit mean over ``dim`` (or all of it) of
    the global batch, computed after shifting by the global maximum."""
    keep = dim is not None
    w = torch.exp(log_w - all_device_max(log_w, dim, keepdim=keep))
    return w / all_device_mean(w, dim, keepdim=keep)
