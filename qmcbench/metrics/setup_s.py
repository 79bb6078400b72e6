"""Seconds from the process's start to the window's: imports, the kernels'
build where it is not cached, weights, walkers, equilibration, warm-up steps."""


def read(ctx):
    return ctx['setup_s']
