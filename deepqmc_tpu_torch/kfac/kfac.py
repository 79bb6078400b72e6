"""Kronecker-factored natural gradient for VMC (counterpart of
``deepqmc_tpu/kfac/kfac.py``, one electronic state).

Every dense layer (``nn.Linear`` and the attention's output product) records
its input ``a`` and, through the instrumented backward of the VMC loss
(:meth:`~..loss.VMCLoss.value_grad_and_taps`), its output sensitivity ``g``.
A layer applied to several rows per walker (electrons) adds one (a, g) pair
per row and carries the block scale ``R`` = rows per walker.  The factors
A = E[a a^T] (with a ones column for a bias) and G = E[g g^T] follow an
exponential moving average; every ``inverse_update_period`` steps their
bias-corrected values are damped, split by pi = sqrt((tr A / dim A) /
(tr G / dim G)) with lambda = damping / R, and inverted, one batched Cholesky
per matrix size.  The update of a dense layer is ``A^-1 [W; b] G^-1 / R``,
that of any other parameter ``g / (1 + damping)``, and the step is scaled to
the trust region ``lr^2 v.g <= norm_constraint``.

The step counter is a host integer, so deciding whether to refresh the
inverses costs no device synchronisation.
"""

import math
from typing import NamedTuple

import torch

from ..nn import instrumented
from ..utils import ConstantSchedule

__all__ = ['KFAC', 'LayerMeta', 'factor_sums']


class LayerMeta(NamedTuple):
    path: str
    in_dim: int
    out_dim: int
    has_bias: bool
    n_calls: int
    # rows per walker of each call: the product of the input's axes between
    # the walker axis and the feature axis
    repeats: tuple[int, ...]
    out_shapes: tuple[tuple[int, ...], ...]


def factor_sums(metas, taps):
    """Per-layer unnormalised factor sums (sum a a^T, sum g g^T) over all rows."""
    sums = {}
    for m in metas:
        A = G = 0
        for (a, g), rep in zip(taps[m.path], m.repeats):
            if rep == 0:
                continue
            a, g = a.reshape(-1, m.in_dim), g.reshape(-1, m.out_dim)
            if m.has_bias:
                a = torch.cat([a, a.new_ones(a.shape[0], 1)], -1)
            A, G = A + a.T @ a, G + g.T @ g
        sums[m.path] = (A, G)
    return sums


def _tree_norm(tensors):
    return torch.sqrt(sum((t**2).sum() for t in tensors))


class KFAC:
    """KFAC on the parameters of ``loss.wf``; the JAX package's defaults
    (``conf/task/opt/kfac.yaml``), estimation mode 'fisher_exact'."""

    CURVATURE_EMA, MIN_DAMPING = 0.95, 1e-8

    def __init__(
        self, loss, *, learning_rate_schedule, damping_schedule=None,
        norm_constraint: float = 1e-3, inverse_update_period: int = 5,
    ):
        self.loss = loss
        self.lr_schedule = learning_rate_schedule
        self.damping_schedule = damping_schedule or ConstantSchedule(1e-3)
        self.norm_constraint = norm_constraint
        self.inverse_update_period = inverse_update_period
        self.metas: list[LayerMeta] = []
        self.layers: dict[str, tuple[torch.nn.Module, str]] = {}  # path -> (module, name)

    def _discover_layers(self, phys_conf) -> list[LayerMeta]:
        """The dense layers one walker's instrumented forward calls, by JAX
        path; layers whose calls have no rows are left to the generic rule."""
        wf, paths = self.loss.wf, self.loss.dense_paths
        names = {mod: name for name, mod in wf.named_modules()}
        one = phys_conf.replace(r=phys_conf.r[:1], mol_idx=phys_conf.mol_idx[:1])
        with torch.no_grad(), instrumented(wf) as rec:
            wf(one)
        metas = []
        for module, calls in rec.calls.items():
            repeats = tuple(math.prod(x.shape[1:-1]) for x, _ in calls)
            if sum(repeats) == 0:
                continue
            in_dim, out_dim = module.w.shape
            metas.append(LayerMeta(
                paths[module], in_dim, out_dim, getattr(module, 'b', None) is not None,
                len(calls), repeats, tuple(tuple(out.shape[1:]) for _, out in calls),
            ))
            self.layers[paths[module]] = (module, names[module])
        return sorted(metas)

    def init(self, phys_conf) -> dict:
        self.metas = self._discover_layers(phys_conf)
        factors, inverses = {}, {}
        for m in self.metas:
            w = self.layers[m.path][0].w
            dims = (m.in_dim + m.has_bias, m.out_dim)
            factors[m.path] = tuple(w.new_zeros(d, d) for d in dims)
            inverses[m.path] = tuple(torch.eye(d, dtype=w.dtype, device=w.device) for d in dims)
        return {'step': 0, 'ema_weight': 0.0, 'factors': factors, 'inverses': inverses}

    def step(self, opt_state, phys_conf, weight):
        """One KFAC step on the walkers ``phys_conf``; updates the parameters in
        place and returns ``(opt_state, (E_loc, None, stats), opt_stats)``."""
        (_, aux), grads, taps = self.loss.value_grad_and_taps(phys_conf, weight)
        opt_state, opt_stats = self.update(opt_state, grads, taps, len(weight))
        return opt_state, aux, opt_stats

    def update(self, opt_state, grads, taps, n_batch: int):
        """The curvature and parameter half of a step from the loss's gradient
        and taps over ``n_batch`` walkers."""
        step = opt_state['step']
        lr = self.lr_schedule(step)
        damping = max(self.damping_schedule(step), self.MIN_DAMPING)
        ema = self.CURVATURE_EMA
        ema_weight = ema * opt_state['ema_weight'] + (1 - ema)
        factors = {}
        for m, (A, G) in zip(self.metas, factor_sums(self.metas, taps).values()):
            total = n_batch * sum(r for r in m.repeats if r > 0)
            A_old, G_old = opt_state['factors'][m.path]
            factors[m.path] = (ema * A_old + (1 - ema) * (A / total),
                               ema * G_old + (1 - ema) * (G / total))
        if step % self.inverse_update_period == 0:
            inverses = self._inverses(factors, ema_weight, damping)
        else:
            inverses = opt_state['inverses']

        updates = {}
        for m in self.metas:
            prefix = f'{self.layers[m.path][1]}.'.lstrip('.')
            W = grads[prefix + 'w']
            if m.has_bias:
                W = torch.cat([W, grads[prefix + 'b'][None]], 0)
            A_inv, G_inv = inverses[m.path]
            V = A_inv @ W @ G_inv / float(sum(m.repeats))
            updates[prefix + 'w'] = V[:-1] if m.has_bias else V
            if m.has_bias:
                updates[prefix + 'b'] = V[-1]
        for k, g in grads.items():
            if k not in updates:  # generic parameters: identity curvature
                updates[k] = g / (1 + damping)

        v_dot_g = torch.clamp(sum((updates[k] * g).sum() for k, g in grads.items()), min=1e-20)
        coeff = torch.clamp(torch.sqrt(self.norm_constraint / (lr**2 * v_dot_g)), max=1.0)
        params = dict(self.loss.wf.named_parameters())
        stats = {
            'opt/lr': lr * coeff,
            'opt/damping': torch.tensor(damping, dtype=v_dot_g.dtype, device=v_dot_g.device),
            'opt/norm_scale': coeff,
            'opt/v_dot_g': v_dot_g,
            'opt/param_norm': _tree_norm(p.detach() for p in params.values()),
            'opt/grad_norm': _tree_norm(grads.values()),
            'opt/update_norm': _tree_norm(updates.values()) * lr * coeff,
        }
        with torch.no_grad():
            for k, p in params.items():
                p.sub_(lr * coeff * updates[k])
        new_state = {'step': step + 1, 'ema_weight': ema_weight, 'factors': factors,
                     'inverses': inverses}
        return new_state, stats

    def _inverses(self, factors, ema_weight, damping):
        """Damped inverses of the bias-corrected factors, batched by matrix size."""
        damped = []  # (path, which, matrix)
        for m in self.metas:
            A, G = (f / ema_weight for f in factors[m.path])
            lam = damping / float(sum(m.repeats))
            tr_a = torch.diagonal(A).sum() / A.shape[0]
            tr_g = torch.diagonal(G).sum() / G.shape[0]
            pi = torch.sqrt(torch.clamp(tr_a, min=1e-20) / torch.clamp(tr_g, min=1e-20))
            eye_a = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
            eye_g = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
            damped.append((m.path, 0, A + (pi * math.sqrt(lam) + 1e-12) * eye_a))
            damped.append((m.path, 1, G + (math.sqrt(lam) / pi + 1e-12) * eye_g))
        by_dim: dict[int, list] = {}
        for entry in damped:
            by_dim.setdefault(entry[2].shape[0], []).append(entry)
        out: dict[str, list] = {m.path: [None, None] for m in self.metas}
        for dim, entries in by_dim.items():
            stacked = torch.stack([e[2] for e in entries])
            eye = torch.eye(dim, dtype=stacked.dtype, device=stacked.device).expand_as(stacked)
            invs = torch.cholesky_solve(eye, torch.linalg.cholesky(stacked))
            for (path, which, _), inv in zip(entries, invs):
                out[path][which] = inv
        return {path: tuple(pair) for path, pair in out.items()}
