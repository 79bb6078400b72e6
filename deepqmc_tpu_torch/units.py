"""Unit conversions (counterpart of ``deepqmc_tpu/units.py``).

CODATA 2018/2022 value of the Bohr radius, as the JAX package reads it from
``scipy.constants``; kept here as a literal so the port needs no scipy.
"""

_BOHR_IN_M = 5.29177210544e-11
_ANGSTROM_IN_M = 1e-10


def angstrom_to_bohr(x):
    return x * _ANGSTROM_IN_M / _BOHR_IN_M


def null(x):
    """Identity conversion."""
    return x
