"""ECP parameters: the registry, the GAMESS-US parser and the packaged tables
(counterpart of ``deepqmc_tpu/ecp/data.py``).

Parameters per element are ``(n_core, local, nonlocal)`` in pyscf's ``_ecp``
layout: ``local`` three lists of ``[alpha, beta]`` pairs for the r^-1, r^0
and r^1 Gaussian classes, ``nonlocal`` one list of such pairs per angular
momentum.  Their sources, highest precedence first: :func:`register_ecp_params`,
a directory of GAMESS-format files (``ecp_dir`` or ``DEEPQMC_TPU_ECP_DIR``),
the opt-in refits (``DEEPQMC_TPU_ECP_USE_REFIT``, a comma list of element
symbols or ``all``) and the packaged tables of :mod:`.tables`.
"""

import logging
import os
import re
from pathlib import Path
from typing import Optional

from .tables import REFIT_TABLES, TABLES

log = logging.getLogger(__name__)

__all__ = ['get_ecp_params', 'parse_gamess_ecp', 'register_ecp_params']

ELEMENTS = (
    'H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co Ni '
    'Cu Zn Ga Ge As Se Br Kr'
).split()
Z_OF = {sym.lower(): i + 1 for i, sym in enumerate(ELEMENTS)}

# (ecp_type.lower(), z) -> (n_core, local, nonlocal), and the source of each
_REGISTRY: dict = {}
_SOURCE: dict = {}
_SOURCE_RANK = {'packaged': 0, 'refit': 1, 'dir': 2, 'user': 3}
_LOADED_DIRS: set = set()


def register_ecp_params(ecp_type: str, z: int, n_core: int, local, nonlocal_,
                        _source: str = 'user'):
    """Register the parameters of one element; a source of lower precedence
    does not replace one of higher."""
    key = (ecp_type.lower(), int(z))
    if key in _REGISTRY and _SOURCE_RANK[_source] < _SOURCE_RANK.get(_SOURCE.get(key, ''), -1):
        return
    _REGISTRY[key] = (n_core, local, nonlocal_)
    _SOURCE[key] = _source


def parse_gamess_ecp(text: str):
    """``(symbol, n_core, local, nonlocal)`` of one element's ECP in GAMESS-US
    format: a header ``<SYM>-ECP GEN <n_core> <l_max>``, then channels of
    ``<n_terms>`` lines ``<coeff> <r-power> <exponent>``, the local channel
    (l = l_max) first and then l = 0 .. l_max - 1."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip() and not ln.startswith('#')]
    header = lines[0].split()
    sym = header[0].split('-')[0]
    n_core = int(header[2])
    idx, channels = 1, []
    while idx < len(lines):
        n_terms = int(lines[idx].split()[0])
        idx += 1
        terms = []
        for _ in range(n_terms):
            coeff, power, exponent = lines[idx].split()[:3]
            terms.append((float(coeff), int(power), float(exponent)))
            idx += 1
        channels.append(terms)
    local = [[], [], []]  # r^-1, r^0, r^1: GAMESS power n means r^(n-2)
    for coeff, power, exponent in channels[0]:
        if not 1 <= power <= 3:
            raise ValueError(f'unsupported local r-power {power}')
        local[power - 1].append([exponent, coeff])
    nonlocal_ = []
    for terms in channels[1:]:
        if any(power != 2 for _, power, _ in terms):
            raise ValueError('unsupported nonlocal r-power')
        nonlocal_.append([[exponent, coeff] for coeff, _, exponent in terms])
    return sym, n_core, local, nonlocal_


def _load_dir(ecp_dir: Path, ecp_type: str):
    pattern = re.compile(r'\.(gamess|ecp|txt)$', re.IGNORECASE)
    for f in sorted(Path(ecp_dir).glob('*')):
        if not pattern.search(f.name):
            continue
        try:
            sym, n_core, local, nonlocal_ = parse_gamess_ecp(f.read_text())
        except Exception as exc:  # noqa: BLE001 (a foreign file in the directory)
            log.warning(f'Could not parse ECP file {f}: {exc}')
            continue
        z = Z_OF.get(sym.lower())
        if z:
            register_ecp_params(ecp_type, z, n_core, local, nonlocal_, _source='dir')


def _register_table(text: str, ecp_type: str, source: str):
    sym, n_core, local, nonlocal_ = parse_gamess_ecp(text)
    z = Z_OF.get(sym.lower())
    if not z:
        return
    key = (ecp_type.lower(), z)
    already = key in _REGISTRY and (
        _SOURCE_RANK.get(_SOURCE.get(key, ''), -1) >= _SOURCE_RANK[source])
    if not already and 'IN-HOUSE' in text:
        log.warning(
            f'The packaged {ecp_type} ECP table for {sym} is an IN-HOUSE LDA refit, NOT the '
            'published file (provenance: deepqmc_tpu/ecp/tables/README.md). Energies for '
            f'systems containing {sym} are not directly comparable to published {ecp_type} '
            'literature values; supply the published file via DEEPQMC_TPU_ECP_DIR for '
            'production use.'
        )
    register_ecp_params(ecp_type, z, n_core, local, nonlocal_, _source=source)


def _load_packaged(ecp_type: str):
    """Register the packaged tables of ``ecp_type``, and the refits opted into."""
    for _, text in sorted(TABLES.get(ecp_type, {}).items()):
        _register_table(text, ecp_type, 'packaged')
    use_refit = os.environ.get('DEEPQMC_TPU_ECP_USE_REFIT', '')
    if use_refit:
        wanted = {s.strip().lower() for s in use_refit.split(',')}
        for sym, text in sorted(REFIT_TABLES.get(ecp_type, {}).items()):
            if 'all' in wanted or sym.lower() in wanted:
                log.info(f'Opt-in in-house refit {ecp_type} table for {sym}')
                _register_table(text, ecp_type, 'refit')


def get_ecp_params(ecp_type: str, z: int, ecp_dir: Optional[str] = None):
    """``(n_core, local, nonlocal)`` of element ``z``, from the source of
    highest precedence that has it; raises where none has."""
    key = (ecp_type.lower(), int(z))
    ecp_dir = ecp_dir or os.environ.get('DEEPQMC_TPU_ECP_DIR')
    if ecp_dir:
        dir_key = (str(Path(ecp_dir).resolve()), ecp_type.lower())
        if dir_key not in _LOADED_DIRS:
            _load_dir(Path(ecp_dir), ecp_type)
            _LOADED_DIRS.add(dir_key)
    if key not in _REGISTRY or _SOURCE.get(key) in ('packaged', 'refit'):
        _load_packaged(ecp_type)
    if key not in _REGISTRY:
        raise ValueError(
            f'No {ecp_type!r} ECP parameters available for element Z={z}. Register them with '
            'deepqmc_tpu_torch.ecp.register_ecp_params or point DEEPQMC_TPU_ECP_DIR at a '
            'directory of GAMESS-format ECP files (e.g. from pseudopotentiallibrary.org).'
        )
    return _REGISTRY[key]
