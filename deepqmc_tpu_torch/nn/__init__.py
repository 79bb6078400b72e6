"""Neural-network modules of the port."""

from .core import (  # noqa: F401
    DenseTaps,
    Module,
    array_init,
    constant_init,
    current_generator,
    dense_layer_paths,
    init_generator,
    instrumented,
    jax_param_paths,
    ones_init,
    variance_scaling,
    zeros_init,
)
from .modules import (  # noqa: F401
    GLU,
    MLP,
    Embed,
    Identity,
    LayerNorm,
    Linear,
    MultiHeadAttention,
    ResidualConnection,
    SumPool,
    ssp,
)
