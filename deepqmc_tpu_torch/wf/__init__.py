"""Wave-function ansatz of the port (PsiFormer)."""

from .nn_wave_function import NeuralNetworkWaveFunction  # noqa: F401
