"""Blocking device-to-host waits a window step: the program's ``syncs``
counter summed over each step's spans, the mean over the window."""

from qmcbench.program_spans import syncs_per_step


def read(ctx):
    return syncs_per_step(ctx)
