"""Molecules of the port (counterpart of ``deepqmc_tpu/molecule.py``).

The geometries are the JAX package's ``conf/hamil/mol/{H2,LiH,H2O}.yaml``,
kept here as Python data: the port reads no YAML.
"""

from dataclasses import dataclass

import numpy as np

from .units import angstrom_to_bohr, null

__all__ = ['Molecule']

_MOLECULES = {
    'H2': dict(coords=[[0.0, 0.0, 0.0], [0.742, 0.0, 0.0]], charges=[1, 1],
               charge=0, spin=0, unit='angstrom'),
    'LiH': dict(coords=[[0.0, 0.0, 0.0], [1.595, 0.0, 0.0]], charges=[3, 1],
                charge=0, spin=0, unit='angstrom'),
    'H2O': dict(coords=[[0.0, 0.0, 0.0], [0.75695, 0.58588, 0.0],
                        [-0.75695, 0.58588, 0.0]],
                charges=[8, 1, 1], charge=0, spin=0, unit='angstrom'),
}


@dataclass(frozen=True, init=False)
class Molecule:
    """Nuclear coordinates ``[n_nuc, 3]`` (bohr), charges, total charge and spin."""

    coords: np.ndarray
    charges: np.ndarray
    charge: int
    spin: int

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
