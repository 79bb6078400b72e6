"""The profiled window's device-idle time inside no program span (the
harness's own code between steps), in % of the idle time: the spans'
coverage."""

from qmcbench.program_spans import unattributed_share


def read(ctx):
    return unattributed_share(ctx)
