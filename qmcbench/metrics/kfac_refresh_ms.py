"""The mean host ms of a KFAC inverse refresh (the ``kfac.inverses`` span)
over every refresh of the window, profiled steps or not."""

from qmcbench.program_spans import refresh_ms


def read(ctx):
    return refresh_ms(ctx)
