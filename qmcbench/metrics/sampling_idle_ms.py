"""The device's idle ms a profiled step while the host is in an innermost
``sampling.*`` span (the Metropolis moves, the psi refresh): the idle
stretches intersected exactly with the program's spans
(``qmcbench/program_spans.py``)."""

from qmcbench.program_spans import layer_idle_ms


def read(ctx):
    return layer_idle_ms(ctx, 'sampling')
