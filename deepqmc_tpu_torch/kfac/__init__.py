"""Kronecker-factored approximate curvature (natural gradient) for VMC."""

from .kfac import KFAC, LayerMeta, factor_sums  # noqa: F401
