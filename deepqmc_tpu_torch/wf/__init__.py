"""Wave-function ansätze of the port (PsiFormer, FermiNet, PauliNet-style `default`)."""

from .nn_wave_function import NeuralNetworkWaveFunction  # noqa: F401
