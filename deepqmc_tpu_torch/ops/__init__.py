"""The port's kernels, each beside its plain PyTorch version."""

from .fl_attention import mha_core_fl, mha_core_fl_plain  # noqa: F401
from .fl_block import psiformer_block_fl, psiformer_block_fl_plain  # noqa: F401
from .fl_slogdet import (  # noqa: F401
    slogdet_fl_flat_split,
    slogdet_fl_square,
    slogdet_fl_square_split,
    slogdet_traces,
    slogdet_traces_plain,
    square_split_traces,
    square_split_traces_plain,
    square_traces,
    square_traces_plain,
)
from .slogdet import slogdet, slogdet_flat, unflatten_dets  # noqa: F401
