"""Checks of a composed task config (counterpart of
``deepqmc_tpu/validate_kwargs.py``): each rule looks at the task and returns
a message or None; the first two messages are logged as warnings.  The last
two are errors, as the JAX package's asserts are: walkers that do not split
evenly across the processes (one per GPU), and a molecule batch larger than
the dataset; each raises a ``ValueError``."""

import logging
from typing import Optional

from .parallel import get_process_count

log = logging.getLogger(__name__)

__all__ = ['validate_kwargs']


def _dig(cfg: dict, *path, default=None):
    """Nested ``get`` tolerating None at any level."""
    node = cfg
    for key in path:
        node = (node or {}).get(key)
        if node is None:
            return default
    return node


def _rule_fix_spin(cfg: dict) -> Optional[str]:
    spin_penalized = _dig(cfg, 'loss_function_factory', 'spin_penalty')
    cas = _dig(cfg, 'pretrain_kwargs', 'scf_kwargs', 'cas')
    fix_spin = _dig(cfg, 'pretrain_kwargs', 'scf_kwargs', 'fix_spin')
    if spin_penalized and cfg.get('pretrain_steps') and cas and not fix_spin:
        return ('Variational training involves spin penalty. Consider adding the fix_spin '
                'argument for the SCF baseline used for pretraining.')
    return None


def _rule_excited_needs_cas(cfg: dict) -> Optional[str]:
    multi_state = cfg.get('electronic_states', 1) not in (1, None)
    if multi_state and not _dig(cfg, 'pretrain_kwargs', 'scf_kwargs', 'cas'):
        return ('No CAS specified, all electronic states will be pretrained to the HF ground '
                'state.')
    return None


def _rule_walker_divisibility(cfg: dict) -> Optional[str]:
    n_dev = get_process_count()
    walkers = cfg.get('electron_batch_size', 0) or 0
    if walkers % n_dev:
        raise ValueError(f'Electron batch size ({walkers}) cannot be evenly split across {n_dev} '
                         'devices!')
    return None


def _rule_molecule_batch(cfg: dict) -> Optional[str]:
    mols = cfg.get('mols')
    if isinstance(mols, dict):
        from .config import instantiate

        mols = instantiate(mols)
    n_mols = len(mols) if mols is not None else 1
    mol_batch = cfg.get('molecule_batch_size', 0) or 0
    if mol_batch > n_mols:
        raise ValueError(f'Molecule batch size ({mol_batch}) is larger than the number of '
                         f'molecules in the dataset ({n_mols})!')
    return None


RULES = (_rule_fix_spin, _rule_excited_needs_cas, _rule_walker_divisibility,
         _rule_molecule_batch)


def validate_kwargs(cfg: dict) -> list[str]:
    """Log a warning for each rule the task config ``cfg`` breaks and raise
    for the two errors; returns the warnings."""
    messages = [m for m in (rule(cfg) for rule in RULES) if m]
    for message in messages:
        log.warning(message)
    return messages
