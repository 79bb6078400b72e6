"""Kernel 1 (the attention core on the forward-Laplacian triple): its bound
over its measured device time, in %, one launch a layer of each local energy."""

from qmcbench.trace import kernel_roofline


def read(ctx):
    cfg = ctx['config']
    if cfg['ansatz'] != 'psiformer':
        return None
    n, H = cfg['n_up'] + cfg['n_down'], cfg['num_heads']
    dh = cfg['embedding_dim'] // H

    def bound(B):
        return cfg['n_interactions'] * ctx['flops'].attention_bound(B, 3 * n, n, H, dh)[0]

    return kernel_roofline(ctx, 'fl_attention', bound)
