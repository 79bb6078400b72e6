"""Reading and merging the result files of a working directory (counterpart of
``deepqmc_tpu/postprocess/workdir.py``).

Reads ``result.h5`` from the ``training`` or ``evaluation`` subdirectory of a
workdir (or from each node's ``training_0``, ``training_1``, ... of a
multi-node run), merges the nodes' samples over the walker axis, and
rearranges the logs of a run over several molecules into one row per
molecule.  ``h5py`` is imported where a file is read, so the module imports
without it (the card's machine has none).
"""

import re
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ['read_and_convert_result', 'read_workdir']


def subscript_sorting_key(name: str) -> int:
    match = re.search(r'.+_(\d+)', name)
    if not match:
        raise ValueError(f'Invalid subdir name {name}')
    return int(match.group(1))


def is_multi_node_subdir(name: str) -> bool:
    if not name.startswith(('training', 'evaluation')):
        raise ValueError(f'Invalid subdir {name}')
    return re.search(r'.+_\d+', name) is not None


def sorted_subdirs(subdirs: list[str]) -> list[str]:
    multi = [is_multi_node_subdir(s) for s in subdirs]
    if any(multi):
        if not all(multi):
            raise ValueError('Mix of single and multi node subdirs')
        keys = sorted(subscript_sorting_key(s) for s in subdirs)
        if keys != list(range(len(subdirs))):
            raise ValueError('Invalid multi-node subscripts')
        return sorted(subdirs, key=subscript_sorting_key)
    if len(subdirs) != 1:
        raise ValueError('Multiple single node subdirs found')
    return subdirs


def chkpt_file_iteration(name: str) -> int:
    match = re.search(r'chkpt-(\d+).pt', name)
    if not match:
        raise ValueError(f'Invalid checkpoint file name: {name}')
    return int(match.group(1))


def last_checkpoint_iteration(path: Path) -> Optional[int]:
    iters = sorted(chkpt_file_iteration(f.name) for f in path.glob('chkpt-*.pt'))
    return iters[-1] if iters else None


def read_subdir(path: Path, keys: list[str]) -> tuple[dict, Optional[int]]:
    last_iter = last_checkpoint_iteration(path)
    result_file = path / 'result.h5'
    if not result_file.exists():
        return {}, None
    import h5py

    with h5py.File(result_file, 'r') as f:
        results = {key: np.array(f[key]) for key in keys if key in f.keys()}
    return results, last_iter


def concatenate_subdir_results(subdir_results) -> tuple[dict, Optional[int]]:
    """Merge per-node results; sample arrays concatenate over the batch axis."""
    if len(subdir_results) == 1:
        return subdir_results[0]
    results, last_iters = zip(*subdir_results)
    if any(it != last_iters[0] for it in last_iters[1:]):
        raise ValueError('Mismatching last checkpoint iterations between subdirs')
    if any(r.keys() != results[0].keys() for r in results[1:]):
        raise ValueError('Mismatching keys between subdirs')
    min_lengths = {k: min(len(r[k]) for r in results) for k in results[0]}
    merged = {
        k: (
            results[0][k]
            if 'samples' not in k
            else np.concatenate([r[k][: min_lengths[k]] for r in results], axis=1)
        )
        for k in results[0]
    }
    return merged, last_iters[0]


def read_workdir(path: Path, keys: list[str]) -> tuple[dict, Optional[int]]:
    """Read whitelisted keys from all result files under a workdir."""
    path = Path(path)
    eval_subdirs = [s.name for s in path.glob('evaluation*')]
    train_subdirs = [s.name for s in path.glob('training*')]
    if not eval_subdirs and not train_subdirs:
        return {}, None
    if eval_subdirs and train_subdirs:
        raise ValueError(
            f'workdir {path} contains both evaluation and training subdirs'
        )
    subdirs = eval_subdirs or train_subdirs
    subdir_results = [read_subdir(path / s, keys) for s in sorted_subdirs(subdirs)]
    return concatenate_subdir_results(subdir_results)


def convert_to_per_molecule_format(
    raw_result: np.ndarray, mol_idxs: np.ndarray
) -> np.ndarray:
    """[n_iter, mol_batch, ...] -> [n_iter_per_mol, n_molecules, ...]."""
    mol_idxs = mol_idxs.astype(int)
    quantity_shape = raw_result.shape[2:]
    n_mol = mol_idxs.max() + 1
    steps_per_mol = mol_idxs.size // n_mol
    even_steps = steps_per_mol * n_mol
    mol_idx = mol_idxs.flatten()[:even_steps]
    result = raw_result.reshape(-1, *quantity_shape)[:even_steps]
    cumulative = np.cumsum(mol_idx[..., None] == np.arange(n_mol), axis=0) - 1
    step_idx = cumulative[np.arange(len(mol_idx)), mol_idx]
    out = np.zeros((steps_per_mol, n_mol, *quantity_shape))
    out[step_idx, mol_idx] = result
    return out


def read_and_convert_result(path, *keys, read_workdir=read_workdir):
    """Read results and rearrange them into per-molecule format."""
    results, _ = read_workdir(path, [*keys, 'mol_idxs'])
    if 'mol_idxs' not in results:
        # mol_idxs is not logged by default for single-molecule runs
        results['mol_idxs'] = np.zeros(
            (max((len(v) for v in results.values()), default=0), 1)
        )
    min_len = min((len(v) for v in results.values()), default=0)
    return {
        k: convert_to_per_molecule_format(
            results[k][:min_len], results['mol_idxs'][:min_len]
        )
        for k in keys
        if k in results
    }
