"""Kernel 2 (the log-determinants on the forward-Laplacian triple): its bound
over its measured device time, in %, one launch a local energy."""

from qmcbench.trace import kernel_roofline


def read(ctx):
    cfg = ctx['config']
    n = cfg['n_up'] + cfg['n_down']

    def bound(B):
        return ctx['flops'].slogdet_bound(B, 3 * n, cfg['n_determinants'], n)[0]

    return kernel_roofline(ctx, 'fl_slogdet', bound)
