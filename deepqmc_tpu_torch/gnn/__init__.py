"""Graph neural networks of the port."""

from .electron_gnn import ElectronEmbedding, ElectronGNN, ElectronGNNLayer  # noqa: F401
