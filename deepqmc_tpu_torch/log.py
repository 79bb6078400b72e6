"""Checkpoints, HDF5 result logging and TensorBoard metric logging
(counterpart of ``deepqmc_tpu/log.py``).

A checkpoint is ``torch.save`` of ``{'step', 'sampler', 'params', 'opt'}``
made of tensors, dicts, lists, tuples and Python scalars only, so
``torch.load(..., weights_only=True)`` reads it; named tuples (``Psi``) are
stored as tagged dicts.  ``params`` is the wave function's ``state_dict``.
With walkers sharded over processes each rank writes its own shard (its
work directory has the suffix ``_<rank>``, as the JAX package's), tagged with
the rank and the number of ranks (a one-process checkpoint has no tags); a restore on as many ranks reads each
rank's own file, and a restore of a one-process checkpoint on several ranks
takes each rank's share of its walkers (the JAX package re-shards too,
``deepqmc_tpu/log.py:88``).
``h5py`` and ``tensorboardX`` are imported by the two sinks' constructors, so
the module loads without them.
"""

import logging
import os
import re
import sys
import time
from functools import partial
from itertools import product
from pathlib import Path
from typing import NamedTuple, Optional, Protocol

import numpy as np
import torch

from .parallel import get_process_count, get_process_index, shard_walkers
from .types import Psi
from .utils import flatten_dict

__all__ = ['CheckpointStore', 'H5LogTable', 'H5Logger', 'MetricLogger',
           'TensorboardMetricLogger', 'copy_train_state']
log = logging.getLogger(__name__)

_NAMED_TUPLES = {'Psi': Psi}


class Checkpoint(NamedTuple):
    step: int
    loss: float
    path: Path


def _to_plain(tree):
    """A copy of ``tree`` that ``weights_only`` loading accepts: tensors cloned
    (contiguous, their own storage), named tuples as tagged dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return {'__namedtuple__': type(tree).__name__, 'fields': [_to_plain(x) for x in tree]}
    if isinstance(tree, dict):
        return {k: _to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_plain(x) for x in tree)
    return tree


def _from_plain(tree):
    if isinstance(tree, dict):
        if '__namedtuple__' in tree:
            return _NAMED_TUPLES[tree['__namedtuple__']](*map(_from_plain, tree['fields']))
        return {k: _from_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_plain(x) for x in tree)
    return tree


def serialize_train_state(step: int, train_state) -> dict:
    """A detached copy of ``(step, train_state)`` as a checkpoint's payload."""
    sampler, params, opt = train_state
    payload = {'step': step, 'sampler': sampler, 'params': params, 'opt': opt}
    if get_process_count() > 1:  # a shard: tagged with its rank
        payload |= {'rank': get_process_index(), 'world_size': get_process_count()}
    return _to_plain(payload)


def deserialize_train_state(payload: dict):
    """``(step, TrainState)`` of a checkpoint's payload; the sampler's visit
    counter goes back to the CPU, where the combined sampler keeps it."""
    from .fit import TrainState

    payload = _from_plain(payload)
    sampler = payload['sampler']
    if sampler is not None and 'update_nuc_counter' in sampler:
        sampler['update_nuc_counter'] = sampler['update_nuc_counter'].cpu()
    if sampler is not None and payload.get('world_size', 1) == 1:
        sampler['elec'] = shard_walkers(sampler['elec'])
    return payload['step'], TrainState(sampler, payload['params'], payload['opt'])


def copy_train_state(train_state):
    """A detached copy of ``train_state`` (its tensors cloned)."""
    return deserialize_train_state(serialize_train_state(0, train_state))[1]


class CheckpointStore:
    """Rolling store of ``(step, TrainState)`` checkpoints.

    ``size`` caps the number of retained checkpoints (the initial one is always
    kept); ``interval`` spaces the dumps in steps.  The files of an earlier run
    in ``workdir`` are removed.  Checkpoints load onto ``device``.
    """

    PATTERN = 'chkpt-{}.pt'

    def __init__(self, workdir: str, *, size: int = sys.maxsize, interval: int = 1000,
                 device=None):
        self.workdir = Path(workdir)
        for p in self.workdir.glob(self.PATTERN.format('*')):
            p.unlink()
        self.size = size
        self.interval = interval
        self.device = device
        self.chkpts: list[Checkpoint] = []
        self.buffer = (None, None, None)

    def update(self, step: int, state, loss=float('inf')):
        # a copy: the parameters change in place after this call
        self.buffer = (step, serialize_train_state(step, state), loss)
        if not self.chkpts or step >= self.interval + self.chkpts[-1].step:
            self.dump()
        while len(self.chkpts) > self.size:
            # pop index 1: index 0 is the pre-training initial checkpoint
            self.chkpts.pop(1).path.unlink()

    def dump(self):
        step, payload, loss = self.buffer
        assert payload is not None and step is not None
        path = self.workdir / self.PATTERN.format(step)
        torch.save(payload, path)
        self.chkpts.append(Checkpoint(step, loss, path))

    @staticmethod
    def load(path, device=None):
        """``(step, TrainState)`` of the checkpoint at ``path``, on ``device``:
        this rank's shard, from the file of this rank where ``path`` is
        another rank's of a run on as many ranks."""
        payload = torch.load(path, map_location=device or 'cpu', weights_only=True)
        world, rank = payload.get('world_size', 1), payload.get('rank', 0)
        if world not in (1, get_process_count()):
            raise ValueError(f'{path} holds a shard of {world} ranks, this run has '
                             f'{get_process_count()}')
        if world > 1 and rank != get_process_index():
            path = Path(path)
            stem = path.parent.name.rsplit('_', 1)[0]
            path = path.parent.with_name(f'{stem}_{get_process_index()}') / path.name
            payload = torch.load(path, map_location=device or 'cpu', weights_only=True)
        return deserialize_train_state(payload)

    def close(self):
        if all(x is not None for x in self.buffer):
            try:
                self.dump()
            except Exception as e:  # noqa: BLE001 (the run is ending anyway)
                log.warning(f'Could not dump final checkpoint: {e!r}')

    @property
    def last(self):
        return self.load(self.chkpts[-1].path, self.device)

    @classmethod
    def extract_step_from_filename(cls, filename: str) -> int:
        match = re.search(cls.PATTERN.format(r'(\d+)'), filename)
        if match is None:
            raise ValueError(f'Invalid checkpoint filename {filename}.')
        return int(match.groups()[0])


def _resize_if_dataset(dataset_type, size: int, name: str, obj):
    if isinstance(obj, dataset_type):
        obj.resize(size, axis=0)


def _optional(package: str, sink: str, key: str):
    """Import ``package`` for ``sink``, or raise naming it and the override
    that turns the sink off."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(
            f'{sink} needs the package {package}, which is not installed here; install it, '
            f'or turn the sink off: task.{key}=null on the command line, or '
            f'{key}=no_sink for train.train'
        ) from e


def no_sink(*args, **kwargs):
    """A sink constructor that gives no sink: the run writes no such output."""
    return None


class H5LogTable:
    """Appendable row-oriented view over an HDF5 group."""

    def __init__(self, group):
        self._group = group

    def resize(self, size: int):
        import h5py

        self._group.visititems(partial(_resize_if_dataset, h5py.Dataset, size))

    @property
    def row(self):
        group = self._group

        class Appender:
            def __setitem__(self, label: str, row):
                row = np.asarray(row) if not isinstance(row, (float, int)) else row
                shape = row.shape if hasattr(row, 'shape') else ()
                if label not in group:
                    dtype = row.dtype if hasattr(row, 'dtype') else float
                    group.create_dataset(label, (0, *shape), maxshape=(None, *shape), dtype=dtype)
                ds = group[label]
                ds.resize(ds.shape[0] + 1, axis=0)
                ds[-1, ...] = row

        return Appender()


class H5Logger:
    """Appends whitelisted statistics to ``result.h5``."""

    def __init__(self, workdir: str, additional_keys_to_whitelist: Optional[list[str]] = None, *,
                 keys_whitelist: Optional[list[str]] = None, init_step: int = 0,
                 aux_data: Optional[dict] = None):
        h5py = _optional('h5py', 'H5Logger', 'h5_logger_constructor')

        self.keys_whitelist = (
            keys_whitelist if keys_whitelist is not None else ['local_energy']
        ) + (additional_keys_to_whitelist or [])
        path = os.path.join(workdir, 'result.h5')
        try:
            self.h5file = h5py.File(path, 'a', libver='v110')
        except OSError as exc:
            # a killed run leaves the HDF5 write lock set: move its log aside
            if 'already open for write' not in str(exc) or not os.path.exists(path):
                raise
            stale = f'{path}.stale-{int(time.time())}'
            os.replace(path, stale)
            log.warning(f'{path} carried a stale HDF5 write lock (crashed run?); '
                        f'moved it to {stale} and starting a fresh log')
            self.h5file = h5py.File(path, 'a', libver='v110')
        for k, v in (aux_data or {}).items():
            self.h5file.attrs.create(k, v)
        self.table = H5LogTable(self.h5file)
        self.table.resize(init_step)
        self.flush()

    def update(self, data: dict):
        for key, value in flatten_dict(data).items():
            if any(phrase in key for phrase in self.keys_whitelist):
                self.write(key, value)
        self.flush()

    def write(self, key: str, data):
        self.table.row[key] = np.asarray(data)

    def flush(self):
        self.h5file.flush()

    def close(self):
        self.h5file.close()


class MetricLogger(Protocol):
    """Protocol for metric sinks fed from the train loop."""

    def __init__(self, workdir: str, n_mol: int): ...

    def update(self, step: int, single_device_stats: dict, multi_device_stats: dict, mol_idxs,
               prefix: Optional[str] = None): ...

    def close(self): ...


class TensorboardMetricLogger:
    """Tensorboard sink with per-molecule/state/state-pair scalar fan-out."""

    def __init__(self, workdir: str, n_mol: int, *, max_queue: int = 10):
        tensorboardx = _optional('tensorboardX', 'TensorboardMetricLogger',
                                 'metric_logger_constructor')
        self.writer = tensorboardx.SummaryWriter(workdir, max_queue=max_queue)
        self.n_mol = n_mol
        self.layout: dict = {}

    def update(self, step: int, single_device_stats: dict, multi_device_stats: dict, mol_idxs,
               prefix: Optional[str] = None):
        prefix = f'{prefix}/' if prefix else ''
        stats = {**(multi_device_stats or {}), **single_device_stats}
        stats = {k: np.asarray(v) for k, v in stats.items()}
        if self.n_mol <= 100:
            self._write_full(step, stats, mol_idxs, prefix)
        else:
            self._write_batched(step, stats, mol_idxs, prefix)

    def _register_layout(self, keys_of, stats: dict, prefix: str):
        for k, v in stats.items():
            keys = keys_of(k, v)
            if keys is None:
                continue
            group = k.split('/')[0]
            self.layout[f'{prefix}{group}'] = {
                k: ['Multiline', keys], **self.layout.get(f'{prefix}{group}', {}),
            }
        self.writer.add_custom_scalars(self.layout)

    def _write_full(self, step, stats, mol_idxs, prefix):
        if step == 0:
            def keys_of(k, v):
                if v.ndim == 1:
                    return [f'{prefix}{k}/{i}' for i in range(self.n_mol)]
                if v.ndim == 2:
                    return [f'{prefix}{k}/{i}/{j}'
                            for i, j in product(range(self.n_mol), range(v.shape[1]))]
                if v.ndim == 3:
                    return [f'{prefix}{k}/{i}/{j}-{m}' for i, j, m in product(
                        range(self.n_mol), range(v.shape[1]), range(v.shape[2]))]
                return None

            self._register_layout(keys_of, stats, prefix)
        for k, v in stats.items():
            if v.ndim == 0:
                self.writer.add_scalar(f'{prefix}{k}', v, step)
            elif v.ndim == 1:
                for i, v_i in zip(mol_idxs, v):
                    self.writer.add_scalar(f'{prefix}{k}/{i}', v_i, step)
            elif v.ndim == 2:
                for i, v_i in zip(mol_idxs, v):
                    for j, v_ij in enumerate(v_i):
                        self.writer.add_scalar(f'{prefix}{k}/{i}/{j}', v_ij, step)
            elif v.ndim == 3 and v.shape[1] == v.shape[2]:
                triu = np.triu_indices(v.shape[2], k=1)
                for i, v_i in zip(mol_idxs, v):
                    for j, m in zip(*triu):
                        self.writer.add_scalar(f'{prefix}{k}/{i}/{m}-{j}', v_i[j, m], step)
            else:
                log.warning(f'Invalid ndim ({v.ndim}) for {k}; skipping TB log.')

    def _write_batched(self, step, stats, mol_idxs, prefix):
        for k, v in stats.items():
            if v.ndim == 0:
                self.writer.add_scalar(f'{prefix}{k}', v, step)
            elif v.ndim == 1:
                self.writer.add_scalar(f'{prefix}{k}/mean', v.mean(), step)
                self.writer.add_scalar(f'{prefix}{k}/std', v.std(), step)
            elif v.ndim == 2:
                for j, (m, s) in enumerate(zip(v.mean(axis=0), v.std(axis=0))):
                    self.writer.add_scalar(f'{prefix}{k}/mean/{j}', m, step)
                    self.writer.add_scalar(f'{prefix}{k}/std/{j}', s, step)
            elif v.ndim == 3 and v.shape[1] == v.shape[2]:
                v_mean, v_std = v.mean(axis=0), v.std(axis=0)
                for j, m in zip(*np.triu_indices(v.shape[2], k=1)):
                    self.writer.add_scalar(f'{prefix}{k}/mean/{m}-{j}', v_mean[j, m], step)
                    self.writer.add_scalar(f'{prefix}{k}/std/{m}-{j}', v_std[j, m], step)

    def close(self):
        self.writer.close()
