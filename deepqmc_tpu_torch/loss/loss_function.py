"""The VMC loss with its direct gradient estimator (counterpart of
``deepqmc_tpu/loss/loss_function.py``, one molecule and one state, no
penalties).

The loss is the weighted mean local energy.  Its gradient is estimated head-on,
never by differentiating the Hamiltonian: the local energies are clipped, the
per-walker coefficient ``c = mask * (E_clip - baseline) * w / sum(mask)`` (the
transpose of the estimator's linear map, which the JAX package gets from
``jax.linear_transpose``; here in closed form,
:func:`~.energy.compute_mean_energy_cotangent`) is pulled back to the
parameters by ONE autograd backward pass of ``sum(c * log|psi|)`` over the
plain forward of the walkers.  For KFAC the same graph is instrumented
(:func:`nn.instrumented`) and a second backward with the all-ones cotangent
gives each dense layer's output sensitivities.

The overlap penalty's options (``alpha``, ``clip_mask_overlap_fn``, ...)
are taken and kept as the JAX package keeps them, which uses them only with
more than one electronic state.  Not ported yet: the spin penalty and more
than one electronic state (ROADMAP.md, queue 1 item 7), and the walker
chunking of the pullback and of the local energy
(``DEEPQMC_TPU_GRAD_WALKER_CHUNK``, ``DEEPQMC_TPU_ELOC_WALKER_CHUNK``).
"""

from typing import Optional

import torch

from ..nn import dense_layer_paths, instrumented
from .energy import compute_local_energy, compute_mean_energy, compute_mean_energy_cotangent

__all__ = ['VMCLoss', 'create_loss_fn']


class VMCLoss:
    """Weighted mean local energy of ``wf``.

    Calling it gives the loss and ``(local_energy, psi_ratio, stats)`` (``psi_ratio``
    is None: one state); :meth:`value_and_grad` adds the gradient, a dict keyed
    as ``wf.named_parameters()``, and :meth:`value_grad_and_taps` the dense
    layers' taps as well.
    """

    def __init__(self, hamil, wf, clip_mask_fn, **overlap_options):
        self.hamil, self.wf, self.clip_mask_fn = hamil, wf, clip_mask_fn
        self.overlap_options = overlap_options  # read only with several states
        self.dense_paths = dense_layer_paths(wf)

    def terms(self, phys_conf, weight):
        """(loss, local energies [B], stats): the forward half, no autograd."""
        local_energy, stats = compute_local_energy(self.hamil, self.wf, phys_conf)
        loss, energy_stats = compute_mean_energy(local_energy, weight)
        return loss, local_energy, stats | energy_stats

    def __call__(self, phys_conf, weight):
        loss, local_energy, stats = self.terms(phys_conf, weight)
        return loss, (local_energy, None, stats)

    def value_and_grad(self, phys_conf, weight):
        loss, local_energy, stats = self.terms(phys_conf, weight)
        grads, _ = self.grad_and_taps(phys_conf, weight, local_energy, taps=False)
        return (loss, (local_energy, None, stats)), grads

    def value_grad_and_taps(self, phys_conf, weight):
        """Loss, gradient and ``taps`` = JAX path -> list per call of
        (input, sensitivity), both ``[B, *repeats, features]``."""
        loss, local_energy, stats = self.terms(phys_conf, weight)
        grads, taps = self.grad_and_taps(phys_conf, weight, local_energy, taps=True)
        return (loss, (local_energy, None, stats)), grads, taps

    def grad_and_taps(self, phys_conf, weight, local_energy, *, taps: bool):
        """The gradient half: clip, form the per-walker cotangent, pull it back."""
        clipped, mask = self.clip_mask_fn(local_energy)
        cotangent = compute_mean_energy_cotangent(clipped, weight, mask)
        params = dict(self.wf.named_parameters())
        with torch.enable_grad():
            if not taps:
                log_psi = self.wf(phys_conf).log
                return self._grads(params, log_psi, cotangent, retain_graph=False), None
            with instrumented(self.wf) as rec:
                log_psi = self.wf(phys_conf).log
            grads = self._grads(params, log_psi, cotangent, retain_graph=True)
            calls = [(self.dense_paths[m], x, out) for m, xs in rec.calls.items() for x, out in xs]
            sens = torch.autograd.grad(
                log_psi, [out for _, _, out in calls], torch.ones_like(log_psi), allow_unused=True
            )
        out = {}
        for (path, x, y), g in zip(calls, sens):
            out.setdefault(path, []).append((x, torch.zeros_like(y) if g is None else g))
        return grads, out

    @staticmethod
    def _grads(params, log_psi, cotangent, retain_graph):
        grads = torch.autograd.grad(
            log_psi, list(params.values()), cotangent, retain_graph=retain_graph,
            allow_unused=True,
        )
        return {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)
        }


def create_loss_fn(
    hamil,
    wf,
    clip_mask_fn,
    clip_mask_overlap_fn=None,
    alpha: Optional[float] = None,
    spin_penalty: Optional[float] = None,
    scale_overlap_by: Optional[str] = None,
    sort_states_by: Optional[str] = None,
    min_gap_scale_factor: float = 0.1,
) -> VMCLoss:
    """Build the VMC loss, with the JAX package's signature.  With one
    electronic state the overlap options are stored and never called, as in
    the JAX package; ``spin_penalty`` raises unless None."""
    if spin_penalty is not None:
        raise NotImplementedError(
            'spin_penalty: the spin penalty and more than one electronic state are not '
            'ported yet (ROADMAP.md, queue 1 item 7)'
        )
    return VMCLoss(hamil, wf, clip_mask_fn, clip_mask_overlap_fn=clip_mask_overlap_fn,
                   alpha=alpha, scale_overlap_by=scale_overlap_by, sort_states_by=sort_states_by,
                   min_gap_scale_factor=min_gap_scale_factor)
