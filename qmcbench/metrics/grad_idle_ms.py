"""The device's idle ms a profiled step while the host is in an innermost
``grad*`` span (clipping, the cotangent, the forward, the backward of
log|psi|, the taps): the idle stretches intersected exactly with the
program's spans (``qmcbench/program_spans.py``)."""

from qmcbench.program_spans import layer_idle_ms


def read(ctx):
    return layer_idle_ms(ctx, 'grad')
