"""Walkers times evaluation steps completed in the window, over the window."""


def read(ctx):
    if ctx['suffix'] != 'eval':
        return None
    return ctx['walkers'] * len(ctx['step_s']) / ctx['window_s']
