"""deepqmc_tpu_torch: the PyTorch/CUDA port of deepqmc_tpu.

It runs the evaluation step of the PsiFormer, FermiNet and PauliNet-style
``default`` ansätze (MCMC sampling, the forward-Laplacian local energy,
energy statistics and EWM) and their training step (the clipped, weighted
VMC gradient, KFAC or Adam, the sampler's psi refresh), with the JAX
package's sampler recipes (Metropolis, Langevin, resampling,
equilibration) over geometries of one molecule, and hand-written
CUDA kernels for the forward-Laplacian attention core, the fused PsiFormer
layer and the log-determinant traces (flat and square layouts).  Around
them, the training run of ``deepqmc_tpu/train.py`` (:mod:`.train`: SCF
pretraining, equilibration, the fit loop, checkpoints with NaN rewinds,
evaluation from a checkpoint), and excited states: several electronic
states, one module each (:class:`.wf.StateStack`), kept apart by the overlap
penalty, with the spin penalty, KFAC over the states, CASCI pretraining
targets and the spin, ratio and oscillator-strength monitors.  Effective
core potentials (:mod:`.ecp`) enter through ``MolecularHamiltonian(ecp_type=)``,
and the command line ``python -m deepqmc_tpu_torch`` (:mod:`.app`) composes
the JAX package's configuration tree (:mod:`.conf`, :mod:`.config`).  It
imports torch, numpy and the standard library only (h5py and tensorboardX
inside the two optional sinks).
"""

from . import train  # noqa: F401  (the module: train.train is the run, fit.train the step loop)
from .fit import eval_step, evaluate  # noqa: F401
from .hamil import MolecularHamiltonian  # noqa: F401
from .molecule import Molecule  # noqa: F401
from .presets import ansatz_preset, default_ansatz, ferminet_ansatz, psiformer_ansatz  # noqa: F401
from .types import PhysicalConfiguration, Psi  # noqa: F401
