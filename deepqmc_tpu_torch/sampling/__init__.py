"""MCMC samplers of the port: the electron samplers and their wrappers, the
combined samplers over molecules and states, equilibration and the recipes."""

from .combined_samplers import (  # noqa: F401
    IdleNucleiSampler,
    MoleculeIdxSampler,
    MultiElectronicStateSampler,
    MultiNuclearGeometrySampler,
    no_elec_warp,
)
from .electron_samplers import (  # noqa: F401
    DecorrSampler,
    LangevinSampler,
    MetropolisSampler,
    ResampledSampler,
)
from .recipes import RECIPES  # noqa: F401
from .sampling_utils import (  # noqa: F401
    chain,
    combine_samplers,
    equilibrate,
    initialize_sampler_state,
    initialize_sampling,
)
