"""Optimizers (counterpart of ``deepqmc_tpu/optimizer.py``, one electronic
state): evaluation only, Adam (the JAX package's ``OptaxOptimizer`` with
``optax.adam``) and KFAC.

Each takes the VMC loss (:class:`~.loss.VMCLoss`), whose wave function holds
the parameters; ``init(phys_conf)`` gives the optimizer state and
``step(opt_state, phys_conf, weight)`` updates the parameters in place and
returns ``(opt_state, E_loc, stats)``.
"""

import torch

from .kfac import KFAC
from .utils import tree_norm

__all__ = ['AdamOptimizer', 'KFACOptimizer', 'NoOptimizer']


class NoOptimizer:
    """Evaluation: the loss's forward half only; the parameters stay."""

    def __init__(self, loss):
        self.loss = loss

    def init(self, phys_conf):
        return None

    def step(self, opt_state, phys_conf, weight):
        _, (E_loc, _, stats) = self.loss(phys_conf, weight)
        return opt_state, E_loc, stats


class AdamOptimizer:
    """``optax.adam(lr)``: bias-corrected first and second moments with optax's
    defaults, ``eps`` added outside the square root."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, loss, lr: float = 1e-3):
        self.loss, self.lr = loss, lr

    def init(self, phys_conf):
        params = dict(self.loss.wf.named_parameters())
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return {'count': 0, 'mu': zeros(), 'nu': zeros()}

    def step(self, opt_state, phys_conf, weight):
        (_, (E_loc, _, stats)), grads = self.loss.value_and_grad(phys_conf, weight)
        count = opt_state['count'] + 1
        b1, b2 = self.B1, self.B2
        mu = {k: (1 - b1) * g + b1 * opt_state['mu'][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g**2 + b2 * opt_state['nu'][k] for k, g in grads.items()}
        c1, c2 = 1 - b1**count, 1 - b2**count
        updates = {
            k: -self.lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.EPS) for k in grads
        }
        params = dict(self.loss.wf.named_parameters())
        stats = {
            'opt/param_norm': tree_norm(p.detach() for p in params.values()),
            'opt/grad_norm': tree_norm(grads.values()),
            'opt/update_norm': tree_norm(updates.values()),
            **stats,
        }
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k])
        return {'count': count, 'mu': mu, 'nu': nu}, E_loc, stats


class KFACOptimizer:
    """Natural gradient with :class:`~.kfac.KFAC` (keyword arguments as KFAC's)."""

    def __init__(self, loss, **kfac_kwargs):
        self.kfac = KFAC(loss, **kfac_kwargs)

    def init(self, phys_conf):
        return self.kfac.init(phys_conf)

    def step(self, opt_state, phys_conf, weight):
        opt_state, (E_loc, _, stats), opt_stats = self.kfac.step(opt_state, phys_conf, weight)
        return opt_state, E_loc, {**opt_stats, **stats}
