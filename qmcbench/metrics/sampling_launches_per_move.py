"""Device operations launched (the runtime's launch event, linked by
correlation id) inside a ``sampling.move`` span of the profiled steps, over
the Metropolis moves counted there."""

from qmcbench.program_spans import launches_per_move


def read(ctx):
    return launches_per_move(ctx)
