"""The device's idle ms a profiled step while the host is in the innermost
``local_energy`` span (the forward Laplacian and the kernels): the idle
stretches intersected exactly with the program's spans
(``qmcbench/program_spans.py``)."""

from qmcbench.program_spans import layer_idle_ms


def read(ctx):
    return layer_idle_ms(ctx, 'local_energy')
