"""The kfac span's device time per step (CUDA events around each call)."""

from qmcbench.trace import span_ms


def read(ctx):
    return span_ms(ctx, 'kfac')
