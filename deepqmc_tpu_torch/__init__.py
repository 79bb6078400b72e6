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
the JAX package's configuration tree (:mod:`.conf`, :mod:`.config`).  The
five Hellmann-Feynman force estimators (:mod:`.force`) and the position
monitors run as observable monitors (``task=evaluate_forces``); the offline
tools read a run's results (:mod:`.postprocess`, :mod:`.oscillator_strength`).
The local energy, the gradient and pretraining's gradient take the walkers in
chunks where asked (``walker_chunk`` keywords, or the JAX package's
``DEEPQMC_TPU_ELOC_WALKER_CHUNK`` and ``DEEPQMC_TPU_GRAD_WALKER_CHUNK``).  It
imports torch, numpy and the standard library only (h5py and tensorboardX
inside the two optional sinks and the result reader).
"""

from . import force, train  # noqa: F401  (train.train is the run, fit.train the step loop)
from .fit import eval_step, evaluate  # noqa: F401
from .hamil import MolecularHamiltonian  # noqa: F401
from .molecule import Molecule  # noqa: F401
from .presets import (  # noqa: F401
    ansatz_preset,
    deeperwin_ansatz,
    default_ansatz,
    ferminet_ansatz,
    psiformer_ansatz,
)
from .types import PhysicalConfiguration, Psi  # noqa: F401
