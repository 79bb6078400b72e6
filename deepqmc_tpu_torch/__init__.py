"""deepqmc_tpu_torch: the PyTorch/CUDA port of deepqmc_tpu.

It runs the evaluation step of the PsiFormer ansatz (MCMC sampling, the
forward-Laplacian local energy, energy statistics and EWM) and its training
step (the clipped, weighted VMC gradient, KFAC or Adam, the sampler's psi
refresh), with the JAX package's sampler recipes (Metropolis, Langevin,
resampling, equilibration) over geometries of one molecule, and hand-written
CUDA kernels for the forward-Laplacian attention core, the fused PsiFormer
layer and the log-determinant traces (flat and square layouts).  It imports
torch, numpy and the standard library only.
"""

from .fit import eval_step, evaluate, train  # noqa: F401
from .hamil import MolecularHamiltonian  # noqa: F401
from .molecule import Molecule  # noqa: F401
from .presets import psiformer_ansatz  # noqa: F401
from .types import PhysicalConfiguration, Psi  # noqa: F401
