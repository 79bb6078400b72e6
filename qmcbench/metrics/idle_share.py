"""1 - (the union of the device's operation intervals) / (the traced
window's wall time), in %."""


def read(ctx):
    prof = ctx['profile']
    if not prof or not prof['busy_s']:
        return None
    return 100 * (1 - prof['busy_s'] / prof['window_s'])
