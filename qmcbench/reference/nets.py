"""The PsiFormer and the FermiNet as plain PyTorch equations.

A frozen, independent statement of the two wave functions the benchmark
runs: von Glehn, Spencer and Pfau, arXiv:2211.13672 (the PsiFormer) and Pfau
et al., arXiv:1909.02487 (the FermiNet), in the form of DeepQMC's
``psiformer`` and ``ferminet`` presets (isotropic exponential envelopes with
one exponent per orbital and nucleus, a multiplicative backflow, full
determinants summed without weights).  Every function takes the parameters
as a dict keyed like the measured network's ``state_dict`` and walkers ``r``
``[B, n, 3]`` in the dtype the caller wants, and returns ``(sign, log|psi|)``
``[B]``.

A dense layer called with a ``tape`` (a list) appends ``(name, input,
output)``: KFAC's factors are built from those (``train.py``).
"""

import math

import torch

__all__ = ['log_psi', 'dense_names']


def norm_safe(d):
    """The Euclidean norm over the last axis with the dtype's epsilon under the root."""
    return torch.sqrt(torch.finfo(d.dtype).eps + (d * d).sum(-1))


def dense(P, name, x, tape=None):
    """``x @ w (+ b)`` of the layer ``name``; recorded on ``tape``."""
    out = x @ P[name + '.w']
    if name + '.b' in P:
        out = out + P[name + '.b']
    if tape is not None:
        tape.append((name, x, out))
    return out


def mlp(P, name, x, n_layers, activation, last_linear, tape=None):
    for i in range(n_layers):
        x = dense(P, f'{name}.layers.{i}', x, tape)
        if i < n_layers - 1 or not last_linear:
            x = activation(x)
    return x


def ne_features(r, R, log_rescale):
    """Per electron, for each nucleus, [|d|, d] with d = r - R (each times
    log(1 + |d|) / |d| with ``log_rescale``): ``[B, n, 4 n_nuc]``."""
    d = r[:, :, None, :] - R[None, None]  # [B, n, n_nuc, 3]
    dist = norm_safe(d)
    feats = torch.cat([dist[..., None], d], -1)
    if log_rescale:
        feats = feats * (torch.log1p(dist) / dist)[..., None]
    return feats.flatten(-2)


def attention(P, name, h, n_heads, tape=None):
    """Multi-head self-attention over the electrons, with its output product."""
    q, k, v = (dense(P, f'{name}.{p}', h, tape).unflatten(-1, (n_heads, -1))
               for p in ('query', 'key', 'value'))
    logits = torch.einsum('bihd,bjhd->bhij', q, k) / math.sqrt(q.shape[-1])
    att = torch.einsum('bhij,bjhd->bihd', torch.softmax(logits, -1), v).flatten(-2)
    return dense(P, name, att, tape)


def envelopes(P, spin, r_s, R):
    """sum_I pi[o, I] exp(-|zeta[o, I]| |r_i - R_I|): ``[B, n_s, n_orb]``."""
    dist = norm_safe(r_s[:, :, None, :] - R[None, None])  # [B, n_s, n_nuc]
    exponent = (P[f'envelope.zetas_{spin}'] * dist[:, :, None, :]).abs()
    return (P[f'envelope.pi_{spin}'] * torch.exp(-exponent)).sum(-1)


def determinants(P, h, r, R, n_up, n_det, tape=None):
    """Orbitals (envelope times backflow) of both spins, the full
    determinants and their sum: ``(sign, log|psi|)``."""
    orbs = []
    for spin, rows in (('up', slice(0, n_up)), ('down', slice(n_up, None))):
        backflow = dense(P, f'omni.backflow.{spin}.nets.0.layers.0', h[:, rows], tape)
        orbs.append(envelopes(P, spin, r[:, rows], R) * backflow)
    a = torch.cat(orbs, 1)  # [B, n, n_det * n], columns det-major
    mats = a.unflatten(-1, (n_det, -1)).movedim(-2, -3)  # [B, n_det, n, n]
    sign, logdet = torch.linalg.slogdet(mats)
    shift = logdet.amax(-1, keepdim=True).detach()
    psi = (sign * torch.exp(logdet - shift)).sum(-1)
    return torch.sign(psi).detach(), torch.log(psi.abs()) + shift[:, 0]


def psiformer(P, cfg, r, R, tape=None):
    n_up = cfg['n_up']
    spin = torch.ones(r.shape[1], dtype=r.dtype, device=r.device)
    spin[n_up:] = -1
    x = torch.cat([ne_features(r, R, True), spin[None, :, None].expand(len(r), -1, 1)], -1)
    h = dense(P, 'omni.gnn.electron_embedding.linear', x, tape)
    for i in range(cfg['n_interactions']):
        name = f'omni.gnn.layers.{i}.update_features.0'
        a = h + attention(P, f'{name}.attention', h, cfg['num_heads'], tape)
        h = a + mlp(P, f'{name}.mlp', a, 2, torch.tanh, False, tape)
    sign, log = determinants(P, h, r, R, n_up, cfg['n_determinants'], tape)
    return sign, log + psiformer_cusp(P, r, n_up)


def psiformer_cusp(P, r, n_up):
    """-sum_pairs scale alpha^2 / (alpha + r_ij): same spin (scale 1/4), opposite (1/2)."""
    n = r.shape[1]
    dev = r.device
    up = torch.triu_indices(n_up, n_up, 1, device=dev)
    down = torch.triu_indices(n - n_up, n - n_up, 1, device=dev)
    same = torch.cat([up, n_up + down], 1)
    ia, ja = torch.meshgrid(torch.arange(n_up, device=dev),
                            n_up + torch.arange(n - n_up, device=dev), indexing='ij')
    total = 0
    for label, scale, (i, j) in (('same', 0.25, same),
                                 ('anti', 0.5, (ia.reshape(-1), ja.reshape(-1)))):
        alpha = P[f'cusp_electrons.{label}_alpha']
        dist = norm_safe(r[:, i] - r[:, j])
        total = total - (scale * alpha**2 / (alpha + dist)).sum(-1)
    return total


def ferminet(P, cfg, r, R, tape=None):
    n_up, n = cfg['n_up'], r.shape[1]
    h = ne_features(r, R, False)
    # electron-electron edges, receiver minus sender, senders first: [B, n, n, 4]
    d = r[:, None, :, :] - r[:, :, None, :]
    e = torch.cat([norm_safe(d)[..., None], d], -1)
    n_layers = cfg['n_interactions']
    for i in range(n_layers):
        msgs = [h, h[:, :n_up].mean(1, keepdim=True).expand(-1, n, -1),
                h[:, n_up:].mean(1, keepdim=True).expand(-1, n, -1),
                e[:, :n_up].mean(1), e[:, n_up:].mean(1)]
        new = mlp(P, f'omni.gnn.layers.{i}.g', torch.cat(msgs, -1), 1, torch.tanh, False, tape)
        h = (h + new) / math.sqrt(2) if new.shape == h.shape else new
        if i < n_layers - 1:
            new_e = mlp(P, f'omni.gnn.layers.{i}.u', e, 1, torch.tanh, False, tape)
            e = (e + new_e) / math.sqrt(2) if new_e.shape == e.shape else new_e
    return determinants(P, h, r, R, n_up, cfg['n_determinants'], tape)


NETS = {'psiformer': psiformer, 'ferminet': ferminet}


def log_psi(P, cfg, r, R, tape=None):
    """``(sign, log|psi|)`` of the configuration ``cfg``'s ansatz."""
    return NETS[cfg['ansatz']](P, cfg, r, R, tape)


def dense_names(P, cfg, R):
    """The dense layers of a forward, each with its rows per walker."""
    n = cfg['n_up'] + cfg['n_down']
    r = torch.linspace(-1, 1, 3 * n, dtype=R.dtype, device=R.device).view(1, n, 3)
    tape = []
    with torch.no_grad():
        log_psi(P, cfg, r, R, tape)
    return {name: math.prod(x.shape[1:-1]) for name, x, _ in tape}
