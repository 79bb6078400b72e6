"""Graph neural networks of the port."""

from .electron_gnn import (  # noqa: F401
    ElectronEmbedding,
    ElectronGNN,
    ElectronGNNLayer,
    NucleiEmbedding,
    PermutationInvariantEmbedding,
)
