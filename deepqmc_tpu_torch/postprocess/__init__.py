"""Post-processing of training and evaluation results (counterpart of
``deepqmc_tpu/postprocess``)."""

from .workdir import read_and_convert_result, read_workdir  # noqa: F401

__all__ = ['read_and_convert_result', 'read_workdir']
