"""Neural-network modules of the port."""

from .core import Module, jax_param_paths, variance_scaling  # noqa: F401
from .modules import (  # noqa: F401
    MLP,
    Identity,
    Linear,
    MultiHeadAttention,
    ResidualConnection,
    SumPool,
)
