"""The JAX package's electron-sampler recipes
(``deepqmc_tpu/conf/task/sampler_factory/*.yaml``) as Python data: each is a
factory ``(hamil, wf) -> sampler`` that ``fit.train`` and ``fit.evaluate`` take
by name."""

from functools import partial

from .electron_samplers import DecorrSampler, LangevinSampler, MetropolisSampler
from .sampling_utils import combine_samplers

__all__ = ['RECIPES']


def decorr_langevin(hamil, wf):
    """``sampler_factory/decorr_langevin.yaml``, the sampler of ``train.yaml``."""
    return combine_samplers(
        [DecorrSampler(length=10), partial(LangevinSampler, tau=1.0)], hamil, wf)


def decorr_metropolis(hamil, wf):
    """``sampler_factory/decorr_metropolis.yaml``."""
    return combine_samplers(
        [DecorrSampler(length=20), partial(MetropolisSampler, tau=1.0, max_age=20)], hamil, wf)


def decorr_metropolis_ferminet(hamil, wf):
    """``sampler_factory/decorr_metropolis_ferminet.yaml``."""
    return combine_samplers(
        [DecorrSampler(length=10),
         partial(MetropolisSampler, tau=0.02, target_acceptance=0.525, max_age=None)],
        hamil, wf)


def decorr_metropolis_psiformer(hamil, wf):
    """``sampler_factory/decorr_metropolis_psiformer.yaml``."""
    return combine_samplers(
        [DecorrSampler(length=30), partial(MetropolisSampler, tau=1.0, max_age=None)], hamil, wf)


RECIPES = {f.__name__: f for f in (
    decorr_langevin, decorr_metropolis, decorr_metropolis_ferminet, decorr_metropolis_psiformer,
)}
