"""Molecules of the port (counterpart of ``deepqmc_tpu/molecule.py``).

The named geometries are the JAX package's ``conf/hamil/mol/*.yaml`` (all 28),
kept here as Python data.  A user's molecule file (``Molecule.from_file``)
and a directory of them (``read_molecule_dataset``) are read by
:func:`read_molecule_file`, which takes the subset of YAML such files use:
flat keys with scalars and flow or block lists of numbers.
"""

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from .units import angstrom_to_bohr, null

__all__ = ['Molecule', 'read_molecule_dataset', 'read_molecule_file']

# name -> the keyword arguments of ``Molecule``, as the YAML file gives them
_MOLECULES = {
    'B': dict(
        coords=[
            [0.0, 0.0, 0.0],
        ],
        charges=[5], charge=0, spin=1, unit='angstrom',
    ),
    'B2': dict(
        coords=[
            [-0.7951, 0.0, 0.0],
            [0.7951, 0.0, 0.0],
        ],
        charges=[5, 5], charge=0, spin=2, unit='angstrom',
    ),
    'Be': dict(
        coords=[
            [0.0, 0.0, 0.0],
        ],
        charges=[4], charge=0, spin=0, unit='angstrom',
    ),
    'Be2': dict(
        coords=[
            [-1.23, 0.0, 0.0],
            [1.23, 0.0, 0.0],
        ],
        charges=[4, 4], charge=0, spin=0, unit='angstrom',
    ),
    'C': dict(
        coords=[
            [0.0, 0.0, 0.0],
        ],
        charges=[6], charge=0, spin=2, unit='angstrom',
    ),
    'C2': dict(
        coords=[
            [-0.621265, 0.0, 0.0],
            [0.621265, 0.0, 0.0],
        ],
        charges=[6, 6], charge=0, spin=0, unit='angstrom',
    ),
    'CH2O': dict(
        coords=[
            [-2.288269281387329, 0.0, 0.0],
            [0.0, 0.0, 0.0],
            [1.125103235244751, -1.7935682535171509, 0.0],
            [1.125103235244751, 1.7935682535171509, 0.0],
        ],
        charges=[8, 6, 1, 1], charge=0, spin=0, unit='bohr',
    ),
    'CH4': dict(
        coords=[
            [0.0, 0.0, 0.0],
            [0.62912, 0.62912, 0.62912],
            [-0.62912, -0.62912, 0.62912],
            [0.62912, -0.62912, -0.62912],
            [-0.62912, 0.62912, -0.62912],
        ],
        charges=[6, 1, 1, 1, 1], charge=0, spin=0, unit='angstrom',
    ),
    'CO': dict(
        coords=[
            [-0.575169, 0.0, 0.0],
            [0.575169, 0.0, 0.0],
        ],
        charges=[6, 8], charge=0, spin=0, unit='angstrom',
    ),
    'CO2': dict(
        coords=[
            [-1.161, 0.0, 0.0],
            [0.0, 0.0, 0.0],
            [1.161, 0.0, 0.0],
        ],
        charges=[8, 6, 8], charge=0, spin=0, unit='angstrom',
    ),
    'H': dict(
        coords=[
            [0.0, 0.0, 0.0],
        ],
        charges=[1], charge=0, spin=1, unit='angstrom',
    ),
    'H10': dict(
        coords=[
            [0.0, 0.0, 0.0],
            [0.95305, 0.0, 0.0],
            [1.9061, 0.0, 0.0],
            [2.85914, 0.0, 0.0],
            [3.81219, 0.0, 0.0],
            [4.76524, 0.0, 0.0],
            [5.71829, 0.0, 0.0],
            [6.67134, 0.0, 0.0],
            [7.62439, 0.0, 0.0],
            [8.57743, 0.0, 0.0],
        ],
        charges=[1, 1, 1, 1, 1, 1, 1, 1, 1, 1], charge=0, spin=0, unit='angstrom',
    ),
    'H2+': dict(
        coords=[
            [-0.52918, 0.0, 0.0],
            [0.52918, 0.0, 0.0],
        ],
        charges=[1, 1], charge=1, spin=1, unit='angstrom',
    ),
    'H2': dict(
        coords=[
            [0.0, 0.0, 0.0],
            [0.742, 0.0, 0.0],
        ],
        charges=[1, 1], charge=0, spin=0, unit='angstrom',
    ),
    'H2O': dict(
        coords=[
            [0.0, 0.0, 0.0],
            [0.75695, 0.58588, 0.0],
            [-0.75695, 0.58588, 0.0],
        ],
        charges=[8, 1, 1], charge=0, spin=0, unit='angstrom',
    ),
    'H2O3': dict(
        coords=[
            [2.256039344065506, 0.07979422300310074, 2.2237440085628726],
            [-2.9879436323137165e-16, -9.67142599187823e-16, 1.267380970753913],
            [0.0, 0.0, 0.0],
            [2.418987015584533, 1.0503857463931796, 2.774087487340858],
            [1.0922959761531792, -6.938893903907228e-16, 1.6065553188661499],
        ],
        charges=[8, 8, 8, 1, 1], charge=0, spin=2, unit='angstrom',
    ),
    'He': dict(
        coords=[
            [0.0, 0.0, 0.0],
        ],
        charges=[2], charge=0, spin=0, unit='angstrom',
    ),
    'Li2': dict(
        coords=[
            [-1.3364, 0.0, 0.0],
            [1.3364, 0.0, 0.0],
        ],
        charges=[3, 3], charge=0, spin=0, unit='angstrom',
    ),
    'LiH': dict(
        coords=[
            [0.0, 0.0, 0.0],
            [1.595, 0.0, 0.0],
        ],
        charges=[3, 1], charge=0, spin=0, unit='angstrom',
    ),
    'LiNH3_6': dict(
        coords=[
            [0.0, 0.0, 0.0],
            [0.0, 0.0, 2.078],
            [-0.9795785942037634, 1.696679895167815, -0.6926666666666663],
            [-0.9795785942037646, -1.6966798951678144, -0.6926666666666662],
            [1.9591571884075278, -4.798551159619614e-16, -0.6926666666666663],
            [0.47015020731013546, 0.8143240462501947, 2.473265898181145],
            [-0.9403004146202705, 1.1515358930016434e-16, 2.473265898181145],
            [0.47015020731013457, -0.8143240462501952, 2.473265898181145],
            [-1.009191989750838, 1.7479718008399818, -1.7109456987677352],
            [-1.9494924043711082, 1.7479718008399818, -0.3811600997067045],
            [-0.5390417824407028, 2.5622958470901764, -0.38116009970670406],
            [-1.009191989750839, -1.7479718008399812, -1.7109456987677352],
            [-0.5390417824407039, -2.562295847090176, -0.38116009970670445],
            [-1.9494924043711093, -1.747971800839981, -0.38116009970670395],
            [2.0183839795016767, -4.943614959894052e-16, -1.7109456987677352],
            [2.4885341868118123, 0.8143240462501944, -0.3811600997067045],
            [2.488534186811812, -0.814324046250195, -0.38116009970670406],
        ],
        charges=[3, 7, 7, 7, 7, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], charge=0, spin=1, unit='bohr',
    ),
    'N2': dict(
        coords=[
            [-2.13534, 0.0, 0.0],
            [2.13534, 0.0, 0.0],
        ],
        charges=[7, 7], charge=0, spin=0, unit='angstrom',
    ),
    'NH3': dict(
        coords=[
            [0.0, 0.0, 0.116488],
            [0.0, 0.93973, -0.27181],
            [0.81383, -0.46986, -0.27181],
            [-0.81383, -0.46986, -0.27181],
        ],
        charges=[7, 1, 1, 1], charge=0, spin=0, unit='angstrom',
    ),
    'O': dict(
        coords=[
            [0.0, 0.0, 0.0],
        ],
        charges=[8], charge=0, spin=2, unit='angstrom',
    ),
    'Sc': dict(
        coords=[
            [0.0, 0.0, 0.0],
        ],
        charges=[21], charge=0, spin=1, unit='angstrom',
    ),
    'ScO': dict(
        coords=[
            [0.0, 0.0, 0.0],
            [1.668, 0.0, 0.0],
        ],
        charges=[21, 8], charge=0, spin=1, unit='angstrom',
    ),
    'benzene': dict(
        coords=[
            [1.391, 0.0, 0.0],
            [0.6955, 1.20464, 0.0],
            [-0.6955, 1.20464, 0.0],
            [-1.391, 0.0, 0.0],
            [-0.6955, -1.20464, 0.0],
            [0.6955, -1.20464, 0.0],
            [2.471, 0.0, 0.0],
            [1.2355, 2.13995, 0.0],
            [-1.2355, 2.13995, 0.0],
            [-2.471, 0.0, 0.0],
            [-1.2355, -2.13995, 0.0],
            [1.2355, -2.13995, 0.0],
        ],
        charges=[6, 6, 6, 6, 6, 6, 1, 1, 1, 1, 1, 1], charge=0, spin=0, unit='angstrom',
    ),
    'bicyclobutane': dict(
        coords=[
            [0.7507, 0.0, -0.3193],
            [-0.7507, 0.0, -0.3193],
            [0.0, 1.135, 0.3153],
            [0.0, -1.135, 0.3153],
            [1.4194, 0.0, -1.1631],
            [-1.4194, 0.0, -1.1631],
            [0.0, 2.082, -0.2148],
            [0.0, -2.082, -0.2148],
            [0.0, 1.2163, 1.402],
            [0.0, -1.2163, 1.402],
        ],
        charges=[6, 6, 6, 6, 1, 1, 1, 1, 1, 1], charge=0, spin=0,
    ),
    'cyclobutadiene_square': dict(
        coords=[
            [0.0, 0.0, 0.0],
            [2.74199, 0.0, 0.0],
            [2.74199, 2.74199, 0.0],
            [0.0, 2.74199, 0.0],
            [-1.44047, -1.44047, 0.0],
            [4.18246, -1.44047, 0.0],
            [4.18246, 4.18246, 0.0],
            [-1.44047, 4.18246, 0.0],
        ],
        charges=[6, 6, 6, 6, 1, 1, 1, 1], charge=0, spin=0, unit='angstrom',
    ),
}


@dataclass(frozen=True, init=False)
class Molecule:
    """Nuclear coordinates ``[n_nuc, 3]`` (bohr), charges, total charge and spin."""

    coords: np.ndarray
    charges: np.ndarray
    charge: int
    spin: int

    all_names = frozenset(_MOLECULES)

    def __init__(self, *, coords, charges, charge, spin, unit='bohr'):
        to_bohr = {'bohr': null, 'angstrom': angstrom_to_bohr}[unit]
        object.__setattr__(self, 'coords', to_bohr(np.asarray(coords, dtype=float)))
        object.__setattr__(self, 'charges', np.asarray(charges, dtype=float))
        object.__setattr__(self, 'charge', charge)
        object.__setattr__(self, 'spin', spin)

    def __len__(self):
        return len(self.charges)

    @classmethod
    def from_name(cls, name: str) -> 'Molecule':
        if name not in _MOLECULES:
            raise ValueError(f'Unknown molecule name: {name} (the port knows {sorted(_MOLECULES)})')
        return cls(**_MOLECULES[name])

    @classmethod
    def from_file(cls, file: str) -> 'Molecule':
        """A molecule from a YAML file of its keyword arguments."""
        return cls(**read_molecule_file(file))


_KEY = re.compile(r'^([A-Za-z_][A-Za-z0-9_]*):(?:[ \t]+(.*))?$')


def _strip_comment(line: str) -> str:
    return re.sub(r'(^|[ \t])#.*$', '', line).rstrip()


def _balanced(text: str) -> bool:
    return text.count('[') == text.count(']')


def read_molecule_file(path) -> dict:
    """The mapping of a molecule file, as ``yaml.safe_load`` reads it, for
    the subset of YAML those files use: top-level ``key: value`` lines whose
    value is a scalar or a flow list (which may run over several lines), or
    ``key:`` followed by an indented block list of such values.  Anything
    else raises ``ValueError``."""
    from .config import parse_value

    lines = [_strip_comment(ln) for ln in Path(path).read_text().splitlines()]
    lines = [ln for ln in lines if ln.strip() and ln.strip() != '---']
    out, i = {}, 0

    def flow(text, i):
        while not _balanced(text):
            if i >= len(lines):
                raise ValueError(f'{path}: unclosed flow list')
            text, i = f'{text} {lines[i].strip()}', i + 1
        return parse_value(text), i

    while i < len(lines):
        m = _KEY.match(lines[i])
        if m is None:
            raise ValueError(f'{path}: line {lines[i]!r} is outside the molecule-file subset '
                             'of YAML (flat keys with scalars and lists of numbers)')
        key, rest, i = m.group(1), (m.group(2) or '').strip(), i + 1
        if key in out:
            raise ValueError(f'{path}: key {key!r} given twice')
        if rest:
            out[key], i = flow(rest, i)
            continue
        items = []
        while i < len(lines) and lines[i][:1] in ' \t-':
            item = lines[i].strip()
            if not item.startswith('- '):
                raise ValueError(f'{path}: line {lines[i]!r} is not a block-list entry')
            value, i = flow(item[2:].strip(), i + 1)
            items.append(value)
        out[key] = items if items else None
    for key, value in out.items():
        if isinstance(value, list) and not _numbers(value):
            raise ValueError(f'{path}: {key} is not a list of numbers')
    return out


def _numbers(value) -> bool:
    if isinstance(value, list):
        return all(_numbers(v) for v in value)
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def read_molecule_dataset(dataset, whitelist: Optional[str] = None) -> dict:
    """name -> :class:`Molecule` of the (whitelisted, by ``re.search`` on the
    name) ``*.yaml`` files of a directory, in the order of their names."""
    molecules = {}
    for f in sorted(Path(dataset).glob('*.yaml')):
        if whitelist is None or re.search(whitelist, f.stem):
            molecules[f.stem] = Molecule.from_file(f)
    return molecules
