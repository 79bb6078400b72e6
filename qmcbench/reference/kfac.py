"""The VMC loss, its gradient and KFAC's step as plain PyTorch.

Loss: the mean local energy of the walkers (unit weights).  Gradient: the
direct estimator E[(E_c - mean E_c) d log|psi|], with the local energies
clipped to ``width`` mean absolute deviations around their median (or mean),
as in the FermiNet and PsiFormer papers.

KFAC (Martens and Grosse, arXiv:1503.05671; the ``kfac_jax`` settings of
DeepQMC's configs, estimation mode 'fisher_exact'): for each dense layer the
factors A = E[a a^T] (a ones column for a bias) and G = E[g g^T], g the
sensitivity of log|psi| at the layer's output, each row of a walker a sample;
moving averages with decay 0.95; every ``inverse_update_period`` steps the
bias-corrected factors, damped by pi sqrt(damping / rows) and sqrt(damping /
rows) / pi (pi from the traces), are inverted.  The update of a dense layer is
A^-1 [dW; db] G^-1 / rows, that of any other parameter its gradient over 1 +
damping; the step is scaled to the trust region lr^2 v.g <= norm_constraint.
"""

import torch

from . import energy, nets

__all__ = ['KFACReference', 'clip']

EMA = 0.95


def clip(E, width, median_center):
    """E clipped to ``width`` mean absolute deviations around the median (or mean)."""
    loc = torch.quantile(E, 0.5) if median_center else E.mean()
    resid = E - loc
    window = width * resid.abs().mean()
    return loc + torch.clamp(resid, -window, window)


class KFACReference:
    """The training steps of ``cfg``'s network from the parameters ``P``
    (float64 copies are kept and updated) under the optimizer settings
    ``opt`` and the clipping ``clip_cfg``."""

    def __init__(self, P, cfg, R, Z, opt, clip_cfg, chunk=256):
        self.P = {k: v.detach().clone() for k, v in P.items()}
        self.cfg, self.R, self.Z, self.opt, self.clip_cfg = cfg, R, Z, opt, clip_cfg
        self.chunk = chunk
        self.rows = nets.dense_names(self.P, cfg, R)
        self.factors, self.inverses = {}, {}
        for name in self.rows:
            w = self.P[name + '.w']
            dims = (w.shape[0] + (name + '.b' in self.P), w.shape[1])
            self.factors[name] = [w.new_zeros(d, d) for d in dims]
            self.inverses[name] = [torch.eye(d, dtype=w.dtype, device=w.device) for d in dims]
        self.step_count, self.ema_weight = 0, 0.0

    def gradient_and_factors(self, r, c):
        """The gradient of sum(c log|psi|) and the factor sums of the dense layers."""
        grads = {k: torch.zeros_like(v) for k, v in self.P.items()}
        sums = {}
        for i in range(0, len(r), self.chunk):
            P = {k: v.detach().requires_grad_() for k, v in self.P.items()}
            tape = []
            with torch.enable_grad():
                _, log = nets.log_psi(P, self.cfg, r[i:i + self.chunk], self.R, tape)
                names = list(P)
                gs = torch.autograd.grad(log, [P[k] for k in names], c[i:i + self.chunk],
                                         retain_graph=True, allow_unused=True)
                sens = torch.autograd.grad(log, [out for *_, out in tape], torch.ones_like(log))
            for k, g in zip(names, gs):
                if g is not None:
                    grads[k] += g
            for (name, x, _), g in zip(tape, sens):
                a = x.detach().reshape(-1, x.shape[-1])
                if name + '.b' in self.P:
                    a = torch.cat([a, a.new_ones(len(a), 1)], -1)
                g = g.reshape(-1, g.shape[-1])
                A, G = sums.get(name, (0, 0))
                sums[name] = (A + a.T @ a, G + g.T @ g)
        return grads, sums

    def step(self, r):
        """One step on the walkers ``r``: (loss, E_loc, its error scale,
        gradient), the parameters updated."""
        B = len(r)
        E, scale = energy.local_energy(self.P, self.cfg, r, self.R, self.Z, with_scale=True)
        Ec = clip(E, **self.clip_cfg)
        c = (Ec - Ec.mean()) / B
        grads, sums = self.gradient_and_factors(r, c)
        self.update(grads, sums, B)
        return E.mean(), E, scale, grads

    def update(self, grads, sums, B):
        opt, step = self.opt, self.step_count
        lr = opt['learning_rate'] / (1 + step / opt['decay_rate'])
        damping = opt['damping']
        self.ema_weight = EMA * self.ema_weight + (1 - EMA)
        for name, (A, G) in sums.items():
            total = B * self.rows[name]
            F = self.factors[name]
            F[0] = EMA * F[0] + (1 - EMA) * A / total
            F[1] = EMA * F[1] + (1 - EMA) * G / total
        if step % opt['inverse_update_period'] == 0:
            for name, (A, G) in self.factors.items():
                A, G = A / self.ema_weight, G / self.ema_weight
                lam = damping / self.rows[name]
                pi = torch.sqrt(torch.clamp(torch.trace(A) / len(A), min=1e-20)
                                / torch.clamp(torch.trace(G) / len(G), min=1e-20))
                self.inverses[name] = [
                    torch.linalg.inv(A + (pi * lam**0.5 + 1e-12) * torch.eye(len(A)).to(A)),
                    torch.linalg.inv(G + (lam**0.5 / pi + 1e-12) * torch.eye(len(G)).to(G))]
        updates = {}
        for name, (A_inv, G_inv) in self.inverses.items():
            W = grads[name + '.w']
            if name + '.b' in grads:
                W = torch.cat([W, grads[name + '.b'][None]], 0)
            V = A_inv @ W @ G_inv / self.rows[name]
            updates[name + '.w'] = V[:len(grads[name + '.w'])]
            if name + '.b' in grads:
                updates[name + '.b'] = V[-1]
        for k, g in grads.items():
            updates.setdefault(k, g / (1 + damping))
        v_dot_g = torch.clamp(sum((updates[k] * g).sum() for k, g in grads.items()), min=1e-20)
        coeff = torch.clamp(torch.sqrt(opt['norm_constraint'] / (lr**2 * v_dot_g)), max=1.0)
        for k in self.P:
            self.P[k] = self.P[k] - lr * coeff * updates[k]
        self.step_count += 1
