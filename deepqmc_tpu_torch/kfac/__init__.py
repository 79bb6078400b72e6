"""Kronecker-factored approximate curvature (natural gradient) for VMC."""

from .kfac import KFAC, LayerMeta  # noqa: F401
