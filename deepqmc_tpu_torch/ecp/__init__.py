"""Effective core potentials of the port (semi-local, Gaussian type)."""

from .data import get_ecp_params, parse_gamess_ecp, register_ecp_params  # noqa: F401
from .gaussian_type_ecp import GaussianTypeECP  # noqa: F401
