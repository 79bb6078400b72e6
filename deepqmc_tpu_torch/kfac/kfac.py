"""Kronecker-factored natural gradient for VMC (counterpart of
``deepqmc_tpu/kfac/kfac.py``), over one or more electronic states.

Every dense layer (``nn.Linear`` and the attention's output product) records
its input ``a`` and, through the instrumented backward of the VMC loss, its
output sensitivity ``g``; the loss returns their sums over the rows
(:meth:`~..loss.VMCLoss.value_grad_and_taps`).
A layer applied to several rows per walker (electrons) adds one (a, g) pair
per row and carries the block scale ``R`` = rows per walker.  The factors
A = E[a a^T] (with a ones column for a bias) and G = E[g g^T] follow an
exponential moving average; every ``inverse_update_period`` steps their
bias-corrected values are damped, split by pi = sqrt((tr A / dim A) /
(tr G / dim G)) with lambda = damping / R, and inverted, one batched Cholesky
per matrix size.  The update of a dense layer is ``A^-1 [W; b] G^-1 / R``,
that of any other parameter ``g / (1 + damping)``, and the step is scaled to
the trust region ``lr^2 v.g <= norm_constraint``.

With S > 1 electronic states (a :class:`~..wf.StateStack`) each state has
its own factors, moving averages and inverses (the layers are those of
state 0, which all states share); the inverses of all states and layers are
refreshed in one batched Cholesky per matrix size, and ONE trust region
covers every state: ``v.g`` is summed over the states and a single scale
multiplies all their updates.  The optimizer state's ``factors`` and
``inverses`` are then lists, one entry per state; for one state they are
the entry itself.

The factor sums are over every molecule of a step's batch and every rank
(the loss sums them over the ranks), normalised by the global count of
walkers a state, ``mol x walker`` over the ranks (JAX ``kfac.py:282-285``).
The gradients and factors being the same on every rank, so are the
inverses, the trust region and the update: the parameters stay bitwise
equal across the ranks without a broadcast.

The step counter is a host integer, so deciding whether to refresh the
inverses costs no device synchronisation.
"""

import math
from typing import NamedTuple

import torch

from .. import tracing
from ..nn import instrumented
from ..utils import ConstantSchedule

__all__ = ['KFAC', 'LayerMeta']


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


def _tree_norm(tensors):
    return torch.sqrt(sum((t**2).sum() for t in tensors))


class KFAC:
    """KFAC on the parameters of ``loss.wf``; the JAX package's defaults
    (``conf/task/opt/kfac.yaml``), estimation mode 'fisher_exact'."""

    CURVATURE_EMA, MIN_DAMPING = 0.95, 1e-8

    def __init__(
        self, loss, *, learning_rate_schedule, damping_schedule=None,
        norm_constraint: float = 1e-3, inverse_update_period: int = 5,
        estimation_mode: str = 'fisher_exact', num_burnin_steps: int = 0,
    ):
        if estimation_mode != 'fisher_exact' or num_burnin_steps:
            raise NotImplementedError(
                f'KFAC with estimation_mode={estimation_mode!r} and num_burnin_steps='
                f"{num_burnin_steps}: the port has 'fisher_exact' without burn-in steps, as "
                'the JAX package\'s configs set it')
        self.loss = loss
        self.lr_schedule = learning_rate_schedule
        self.damping_schedule = damping_schedule or ConstantSchedule(1e-3)
        self.norm_constraint = norm_constraint
        self.inverse_update_period = inverse_update_period
        self.metas: list[LayerMeta] = []
        self.layers: dict[str, str] = {}  # JAX path -> module name within a state's module

    def _discover_layers(self, phys_conf) -> list[LayerMeta]:
        """The dense layers one walker's instrumented forward of state 0 calls,
        by JAX path; layers whose calls have no rows are left to the generic
        rule.  ``phys_conf`` holds walkers of one state."""
        wf, paths = self.loss.states[0], self.loss.dense_paths[0]
        names = {mod: name for name, mod in wf.named_modules()}
        one = phys_conf.walkers(slice(0, 1))
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
            self.layers[paths[module]] = names[module]
        return sorted(metas)

    def _per_state(self, x):
        """A per-state entry (grads, taps, factors) as a list over the states."""
        return x if self.loss.multi else [x]

    def _public(self, xs):
        return xs if self.loss.multi else xs[0]

    def init(self, phys_conf) -> dict:
        """The optimizer state for walkers like ``phys_conf`` (in a layout of
        :class:`~..loss.VMCLoss`)."""
        self.metas = self._discover_layers(self.loss.grid_conf(phys_conf).state(0))
        w = self.loss.states[0].get_submodule(self.layers[self.metas[0].path]).w
        factors, inverses = [], []
        for _ in self.loss.states:
            dims = {m.path: (m.in_dim + m.has_bias, m.out_dim) for m in self.metas}
            factors.append({p: tuple(w.new_zeros(d, d) for d in ds) for p, ds in dims.items()})
            inverses.append({p: tuple(torch.eye(d, dtype=w.dtype, device=w.device) for d in ds)
                             for p, ds in dims.items()})
        return {'step': 0, 'ema_weight': 0.0, 'factors': self._public(factors),
                'inverses': self._public(inverses)}

    def step(self, opt_state, phys_conf, weight, data=None):
        """One KFAC step on the walkers ``phys_conf``; updates the parameters in
        place and returns ``(opt_state, (E_loc, psi_ratio, stats), opt_stats)``."""
        (_, aux), grads, sums = self.loss.value_grad_and_taps(phys_conf, weight, data)
        opt_state, opt_stats = self.update(opt_state, grads, sums, self.loss.n_walkers(weight))
        return opt_state, aux, opt_stats

    def update(self, opt_state, grads, sums, n_batch: int):
        """The curvature and parameter half of a step from the loss's gradient
        and factor sums (:meth:`~..loss.VMCLoss.value_grad_and_taps`) over ``n_batch``
        walkers a state (over the molecules and ranks)."""
        with tracing.span('kfac.update'):
            step = opt_state['step']
            lr = self.lr_schedule(step)
            damping = max(self.damping_schedule(step), self.MIN_DAMPING)
            ema = self.CURVATURE_EMA
            ema_weight = ema * opt_state['ema_weight'] + (1 - ema)
            grads, sums = self._per_state(grads), self._per_state(sums)
            with tracing.span('kfac.factors'):
                factors = []
                for old, state_sums in zip(self._per_state(opt_state['factors']), sums):
                    factors.append({})
                    for m in self.metas:
                        A, G = state_sums[m.path]
                        total = n_batch * sum(r for r in m.repeats if r > 0)
                        A_old, G_old = old[m.path]
                        factors[-1][m.path] = (ema * A_old + (1 - ema) * (A / total),
                                               ema * G_old + (1 - ema) * (G / total))
            if step % self.inverse_update_period == 0:
                with tracing.span('kfac.inverses'):
                    inverses = self._inverses(factors, ema_weight, damping)
            else:
                inverses = self._per_state(opt_state['inverses'])

            with tracing.span('kfac.precondition'):
                updates = [self._precondition(g, inv, damping) for g, inv in zip(grads, inverses)]
                # one trust region over all states: v.g summed over every state
                v_dot_g = torch.clamp(sum((u[k] * g).sum() for u, gs in zip(updates, grads)
                                          for k, g in gs.items()), min=1e-20)
                coeff = torch.clamp(torch.sqrt(self.norm_constraint / (lr**2 * v_dot_g)), max=1.0)
                params = [dict(s.named_parameters()) for s in self.loss.states]
                stats = {
                    'opt/lr': lr * coeff,
                    'opt/damping': torch.tensor(damping, dtype=v_dot_g.dtype,
                                                device=v_dot_g.device),
                    'opt/norm_scale': coeff,
                    'opt/v_dot_g': v_dot_g,
                    'opt/param_norm': _tree_norm(p.detach() for ps in params for p in ps.values()),
                    'opt/grad_norm': _tree_norm(g for gs in grads for g in gs.values()),
                    'opt/update_norm': (_tree_norm(v for u in updates for v in u.values())
                                        * lr * coeff),
                }
                with torch.no_grad():
                    for ps, u in zip(params, updates):
                        for k, p in ps.items():
                            p.sub_(lr * coeff * u[k])
            new_state = {'step': step + 1, 'ema_weight': ema_weight,
                         'factors': self._public(factors), 'inverses': self._public(inverses)}
            return new_state, stats

    def _precondition(self, grads, inverses, damping):
        """One state's update: ``A^-1 [W; b] G^-1 / R`` for a dense layer, the
        gradient over ``1 + damping`` for any other parameter."""
        updates = {}
        for m in self.metas:
            prefix = f'{self.layers[m.path]}.'.lstrip('.')
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
        return updates

    def _inverses(self, factors, ema_weight, damping):
        """Damped inverses of the bias-corrected factors of every state,
        batched by matrix size."""
        damped = []  # (state, path, which, matrix)
        for s, state_factors in enumerate(factors):
            for m in self.metas:
                A, G = (f / ema_weight for f in state_factors[m.path])
                lam = damping / float(sum(m.repeats))
                tr_a = torch.diagonal(A).sum() / A.shape[0]
                tr_g = torch.diagonal(G).sum() / G.shape[0]
                pi = torch.sqrt(torch.clamp(tr_a, min=1e-20) / torch.clamp(tr_g, min=1e-20))
                eye_a = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
                eye_g = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
                damped.append((s, m.path, 0, A + (pi * math.sqrt(lam) + 1e-12) * eye_a))
                damped.append((s, m.path, 1, G + (math.sqrt(lam) / pi + 1e-12) * eye_g))
        by_dim: dict[int, list] = {}
        for entry in damped:
            by_dim.setdefault(entry[3].shape[0], []).append(entry)
        out = [{m.path: [None, None] for m in self.metas} for _ in factors]
        for dim, entries in by_dim.items():
            stacked = torch.stack([e[3] for e in entries])
            eye = torch.eye(dim, dtype=stacked.dtype, device=stacked.device).expand_as(stacked)
            invs = torch.cholesky_solve(eye, torch.linalg.cholesky(stacked))
            for (s, path, which, _), inv in zip(entries, invs):
                out[s][path][which] = inv
        return [{path: tuple(pair) for path, pair in state.items()} for state in out]
