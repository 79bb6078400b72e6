"""The yardstick: the card's peaks, each kernel's operations and bytes, and
the analytic operation count of a step, all from the configuration's shapes.

The kernel bounds are frozen copies of the shape counts that the port's
smoke run used for kernels 1 and 2 (attention and flat log-determinant);
the compute peak is the split-TF32 one, so no float32-accurate kernel can
read above 100 %.  The step count is of matrix products only (elementwise
work is left out), the same whatever implements the step.
"""

import math

__all__ = ['PEAKS', 'attention_bound', 'dense_layers', 'forward_flops', 'roofline_s',
           'slogdet_bound', 'step_flops']

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense): HBM3 bytes/s; the float32
# product on the tensor cores as split TF32 (495 TFLOP/s TF32 over its three
# TF32 products), the fastest float32-accurate rate the card offers; and the
# SIMT float32 rate outside the tensor cores, for reference
PEAKS = {
    'hbm_bytes_per_s': 3.35e12,
    'f32_flops_per_s': 495e12 / 3,
    'f32_simt_flops_per_s': 67e12,
}


def roofline_s(nbytes, flops):
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / PEAKS['hbm_bytes_per_s'], flops / PEAKS['f32_flops_per_s'])


def attention_bound(B, K=30, n=10, H=4, dh=64, jbytes=4):
    """Kernel 1 (the attention core on the forward-Laplacian triple): (bound
    s, bytes, operations); ``jbytes`` the bytes of a Jacobian element."""
    f = 4
    nbytes = f * B * H * n * dh * (6 + 2) + jbytes * B * K * n * H * dh * (3 + 1)
    flops = B * H * (12 * K * n * n * dh + 12 * n * n * dh + 20 * K * n * n)
    return roofline_s(nbytes, flops), nbytes, flops


def slogdet_bound(B, K=30, D=16, n=10, with_l=False, jbytes=4):
    """Kernels 2-4 (the log-determinants on the forward-Laplacian triple):
    (bound s, bytes, operations); ``with_l`` for the square kernels, which
    also read L and form tr(A^-1 L)."""
    f = 4
    nbytes = (f * ((2 if with_l else 1) * B * D * n * n + B * K * D + B * D)
              + jbytes * B * K * n * D * n)
    flops = B * D * K * (2 * n * n * n + 3 * n * n) + (2 * B * D * n * n if with_l else 0)
    return roofline_s(nbytes, flops), nbytes, flops


def _n(cfg):
    return cfg['n_up'] + cfg['n_down']


def dense_layers(cfg):
    """The dense layers of one forward: (name, in, out, bias, rows per walker)."""
    n, n_nuc, D = _n(cfg), len(cfg['molecule']['charges']), cfg['n_determinants']
    L, d = cfg['n_interactions'], cfg['embedding_dim']
    layers = []
    if cfg['ansatz'] == 'psiformer':
        layers.append(('omni.gnn.electron_embedding.linear', 4 * n_nuc + 1, d, False, n))
        for i in range(L):
            name = f'omni.gnn.layers.{i}.update_features.0'
            layers += [(f'{name}.attention.{p}', d, d, False, n)
                       for p in ('query', 'key', 'value')]
            layers.append((f'{name}.attention', d, d, False, n))
            layers += [(f'{name}.mlp.layers.{j}', d, d, True, n) for j in range(2)]
    elif cfg['ansatz'] == 'ferminet':
        e, f_el, f_e = cfg['two_particle_stream_dim'], 4 * n_nuc, 4
        for i in range(L):
            width = 3 * f_el + 2 * f_e if i == 0 else 3 * d + 2 * e
            layers.append((f'omni.gnn.layers.{i}.g.layers.0', width, d, True, n))
            if i < L - 1:
                layers.append((f'omni.gnn.layers.{i}.u.layers.0', f_e if i == 0 else e, e,
                               True, n * n))
    else:
        raise ValueError(f"no count for the ansatz {cfg['ansatz']!r}")
    for spin, rows in (('up', cfg['n_up']), ('down', cfg['n_down'])):
        layers.append((f'omni.backflow.{spin}.nets.0.layers.0', d, D * n, False, rows))
    return layers


def _attention_core_flops(cfg, B):
    """The two products of the attention cores of a plain forward."""
    if cfg['ansatz'] != 'psiformer':
        return 0
    n, d = _n(cfg), cfg['embedding_dim']
    return cfg['n_interactions'] * B * 2 * (2 * n * n * d)


def forward_flops(cfg, B):
    """The matrix products of a plain forward of ``B`` walkers."""
    dense = sum(2 * B * rows * i * o for _, i, o, _, rows in dense_layers(cfg))
    return dense + _attention_core_flops(cfg, B)


def step_flops(cfg, traffic):
    """A step's operations: the sampling forwards (one a move) and, in
    training, the psi refresh; the forward Laplacian (K + 2 rows through each
    linear map, kernel 1's and kernel 2's counts); in training the backward
    of log|psi| with its forward, the taps' backward, KFAC's factor sums,
    its preconditioning and its inverses amortised over their period.
    Log-determinants of the forwards count 2/3 n^3 each."""
    B, n, D = traffic['walkers'], _n(cfg), cfg['n_determinants']
    K = 3 * n
    train = traffic['optimizer'] is not None
    fwd = forward_flops(cfg, B)
    lu = B * D * 2 * n**3 // 3
    total = (traffic['moves'] + train) * (fwd + lu)
    total += (K + 2) * (fwd - _attention_core_flops(cfg, B))
    if cfg['ansatz'] == 'psiformer':
        dh = cfg['embedding_dim'] // cfg['num_heads']
        total += cfg['n_interactions'] * attention_bound(B, K, n, cfg['num_heads'], dh)[2]
    total += slogdet_bound(B, K, D, n)[2]
    if train:
        total += 4 * fwd + lu
        period = traffic['optimizer']['inverse_update_period']
        for _, i, o, bias, rows in dense_layers(cfg):
            a = i + bias
            total += 2 * B * rows * (a * a + o * o)  # factor sums
            total += 2 * a * a * o + 2 * a * o * o  # preconditioning
            total += math.ceil((2 * a**3 + 2 * o**3) / period)  # inverses
    return total
