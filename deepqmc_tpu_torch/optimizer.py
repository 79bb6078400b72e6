"""Optimizers (counterpart of ``deepqmc_tpu/optimizer.py``): evaluation only,
a gradient transformation as the JAX package's ``OptaxOptimizer`` (with
:func:`adam`, :func:`adamw` or :func:`lamb`; ``AdamOptimizer`` for Adam) and
KFAC.

Each takes the VMC loss (:class:`~.loss.VMCLoss`), whose wave function (one
module or a :class:`~.wf.StateStack`) holds the parameters, and the
``merge_keys`` whose parameters are averaged over the states after every
step (:func:`~.wf.merge_states`); ``init(phys_conf)`` gives the optimizer
state and ``step(opt_state, phys_conf, weight, data=None)`` updates the
parameters in place and returns ``(opt_state, E_loc, psi_ratio, stats)``.

The gradient transformations :func:`adam`, :func:`adamw` and :func:`lamb`
compute what ``optax.adam``, ``optax.adamw`` and ``optax.lamb`` compute, on
dicts of tensors keyed as ``named_parameters()``: ``init(params)`` gives the state and
``update(grads, state, params)`` the updates (to add) and the new state.
Pretraining takes them by name (``PRETRAIN_OPTIMIZERS``).
"""

from typing import NamedTuple

import torch

from .kfac import KFAC
from .utils import tree_norm
from .wf.base import merge_states

__all__ = [
    'AdamOptimizer', 'GradientTransformation', 'KFACOptimizer', 'NoOptimizer',
    'OptaxOptimizer', 'PRETRAIN_OPTIMIZERS', 'adam', 'adamw', 'lamb', 'merge_states',
]


class GradientTransformation(NamedTuple):
    init: object
    update: object


def _scale_by_adam(b1, b2, eps, eps_root=0.0):
    """``optax.scale_by_adam``: bias-corrected moments, ``eps`` outside the root."""

    def init(params):
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return {'count': 0, 'mu': zeros(), 'nu': zeros()}

    def update(grads, state, params=None):
        count = state['count'] + 1
        mu = {k: (1 - b1) * g + b1 * state['mu'][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g**2 + b2 * state['nu'][k] for k, g in grads.items()}
        c1, c2 = 1 - b1**count, 1 - b2**count
        updates = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2 + eps_root) + eps) for k in grads}
        return updates, {'count': count, 'mu': mu, 'nu': nu}

    return init, update


def _learning_rate(learning_rate, count):
    return learning_rate(count) if callable(learning_rate) else learning_rate


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0) -> GradientTransformation:
    """``optax.adam``: Adam's moments, then ``-learning_rate`` (a number or a
    schedule of the step count)."""
    init, scale = _scale_by_adam(b1, b2, eps, eps_root)

    def update(grads, state, params=None):
        lr = _learning_rate(learning_rate, state['count'])
        updates, state = scale(grads, state)
        return {k: u * -lr for k, u in updates.items()}, state

    return GradientTransformation(init, update)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          weight_decay=1e-4) -> GradientTransformation:
    """``optax.adamw``: Adam's moments plus ``weight_decay * param``, then
    ``-learning_rate``."""
    init, scale = _scale_by_adam(b1, b2, eps, eps_root)

    def update(grads, state, params):
        lr = _learning_rate(learning_rate, state['count'])
        updates, state = scale(grads, state)
        return {k: (u + weight_decay * params[k]) * -lr for k, u in updates.items()}, state

    return GradientTransformation(init, update)


def _norm(t):
    return torch.linalg.vector_norm(t)


def lamb(learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
         weight_decay=0.0) -> GradientTransformation:
    """``optax.lamb``: Adam's moments, plus ``weight_decay * param``, scaled per
    parameter by the trust ratio |param| / |update| (1 where either norm is
    zero), then by ``-learning_rate``."""
    init, scale = _scale_by_adam(b1, b2, eps, eps_root)

    def update(grads, state, params):
        lr = _learning_rate(learning_rate, state['count'])
        updates, state = scale(grads, state)
        out = {}
        for k, u in updates.items():
            if weight_decay:
                u = u + weight_decay * params[k]
            p_norm, u_norm = _norm(params[k]), _norm(u)
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            out[k] = u * ratio * -lr
        return out, state

    return GradientTransformation(init, update)


PRETRAIN_OPTIMIZERS = {'adam': adam, 'lamb': lamb}


class NoOptimizer:
    """Evaluation: the loss's forward half only; the parameters stay."""

    def __init__(self, loss, merge_keys=None):
        self.loss = loss

    def init(self, phys_conf):
        return None

    def step(self, opt_state, phys_conf, weight, data=None):
        _, (E_loc, psi_ratio, stats) = self.loss(phys_conf, weight, data)
        return opt_state, E_loc, psi_ratio, stats


class OptaxOptimizer:
    """First-order steps with a gradient transformation ``optax_opt`` (such
    as :func:`adam` or :func:`adamw`).  It acts entry by entry, so the
    parameters of several states are one dict, keyed as the
    ``named_parameters()`` of their :class:`~.wf.StateStack`."""

    def __init__(self, loss, merge_keys=None, *, optax_opt: GradientTransformation):
        self.loss, self.optax_opt, self.merge_keys = loss, optax_opt, merge_keys

    def _params(self):
        states = self.loss.states
        return dict(self.loss.wf.named_parameters() if len(states) > 1
                    else states[0].named_parameters())

    def init(self, phys_conf):
        return self.optax_opt.init(self._params())

    def step(self, opt_state, phys_conf, weight, data=None):
        (_, (E_loc, psi_ratio, stats)), grads = self.loss.value_and_grad(phys_conf, weight, data)
        if self.loss.multi:
            grads = {f'{s}.{k}': g for s, gs in enumerate(grads) for k, g in gs.items()}
        params = self._params()
        with torch.no_grad():
            updates, opt_state = self.optax_opt.update(grads, opt_state, params)
        stats = {
            'opt/param_norm': tree_norm(p.detach() for p in params.values()),
            'opt/grad_norm': tree_norm(grads.values()),
            'opt/update_norm': tree_norm(updates.values()),
            **stats,
        }
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k])
        merge_states(self.loss.wf, self.merge_keys)
        return opt_state, E_loc, psi_ratio, stats


class AdamOptimizer(OptaxOptimizer):
    """``optax.adam(lr)``: bias-corrected first and second moments with optax's
    defaults, ``eps`` added outside the square root."""

    def __init__(self, loss, merge_keys=None, *, lr: float = 1e-3):
        super().__init__(loss, merge_keys, optax_opt=adam(lr))


class KFACOptimizer:
    """Natural gradient with :class:`~.kfac.KFAC`: its keyword arguments, or
    as the JAX package's configs give it, ``kfac=partial(KFAC, ...)`` (a
    factory taking the loss)."""

    def __init__(self, loss, merge_keys=None, *, kfac=None, **kfac_kwargs):
        if kfac is not None and kfac_kwargs:
            raise TypeError('give KFAC either as kfac= or by its keyword arguments')
        self.kfac = kfac(loss) if kfac is not None else KFAC(loss, **kfac_kwargs)
        self.merge_keys = merge_keys

    def init(self, phys_conf):
        return self.kfac.init(phys_conf)

    def step(self, opt_state, phys_conf, weight, data=None):
        opt_state, (E_loc, psi_ratio, stats), opt_stats = self.kfac.step(
            opt_state, phys_conf, weight, data)
        merge_states(self.kfac.loss.wf, self.merge_keys)
        return opt_state, E_loc, psi_ratio, {**opt_stats, **stats}
