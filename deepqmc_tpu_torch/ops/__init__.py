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


def launch_counts() -> dict:
    """Launches of each hand-written kernel so far in this process (its wrapper
    counts one where it launches the kernel on the card, and nowhere else)."""
    from . import fl_attention, fl_block, fl_slogdet

    return {
        'fl_attention': fl_attention.mha_core_fl.launches,
        'fl_slogdet_traces': fl_slogdet.slogdet_traces.launches,
        'fl_slogdet_square': fl_slogdet.square_traces.launches,
        'fl_slogdet_square_split': fl_slogdet.square_split_traces.launches,
        'fl_block': fl_block.psiformer_block_fl.launches,
    }
