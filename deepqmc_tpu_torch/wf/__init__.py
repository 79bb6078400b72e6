"""Wave-function ansätze of the port (PsiFormer, FermiNet, PauliNet-style `default`,
DeepErwin and the transferable components)
and the stack of per-state modules of excited states."""

from .base import StateStack, init_wf_states, merge_states, wf_states  # noqa: F401
from .nn_wave_function import NeuralNetworkWaveFunction  # noqa: F401
