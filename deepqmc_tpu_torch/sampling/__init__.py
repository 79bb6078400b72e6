"""MCMC samplers of the port."""

from .electron_samplers import DecorrSampler, MetropolisSampler  # noqa: F401
