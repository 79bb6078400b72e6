"""Neural-network modules of the port."""

from .core import (  # noqa: F401
    DenseTaps,
    Module,
    dense_layer_paths,
    instrumented,
    jax_param_paths,
    variance_scaling,
)
from .modules import (  # noqa: F401
    MLP,
    Identity,
    Linear,
    MultiHeadAttention,
    ResidualConnection,
    SumPool,
    ones_init,
)
