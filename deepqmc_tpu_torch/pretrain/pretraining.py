"""Supervised pretraining of the ansatz orbitals to the SCF baseline
(counterpart of ``deepqmc_tpu/pretrain/pretraining.py``), one or more
molecules a step, one or more electronic states.

A step draws a batch of molecules, moves their walkers with the sampler (no
grad), and
updates the parameters by the gradient of the mean squared difference
between the ansatz's orbitals (``wf(phys_conf, return_mos=True)``) and the
SCF target's, each state's module held to its own target (its CASCI root,
or the HF determinant) on its own walkers, the loss the mean over the
states.  Each state's walkers of the molecules go through one forward as a
flat batch (``PhysicalConfiguration.state``) with the nuclei per walker,
each held to its molecule's SCF orbitals; with walkers sharded over
processes the gradient is averaged over the ranks.  The optimizer sees each
parameter stacked over the states, as the JAX package's stacked parameters,
so LAMB's trust ratio takes the norms of all states together.  As in the JAX package the sampler's cached psi is
never refreshed after an update.  The gradient may run in walker chunks
(``walker_chunk``, by default ``DEEPQMC_TPU_GRAD_WALKER_CHUNK``), which bound
the memory of its backward.
"""

import logging
import math
import time

import torch

from ..optimizer import GradientTransformation
from ..parallel import get_process_count, sum_over_ranks
from ..types import PhysicalConfiguration
from ..utils import chunk_size
from ..wf.base import wf_states
from .pretraining_target import PretrainTarget

__all__ = ['pretrain', 'pretrain_loss', 'pretrain_update']

log = logging.getLogger(__name__)


def pretrain_loss(hamil, wf, target_fn, confs, conf_coeffs, phys_conf):
    """(loss, per-walker losses ``[B]``) of one molecule's walkers
    (``deepqmc_tpu/pretrain/pretraining.py:46-75``): the target determinants
    tiled to the ansatz's count, and for full determinants the off-diagonal
    spin blocks pretrained to zero."""
    with torch.no_grad():
        target = target_fn(confs, conf_coeffs, phys_conf)  # [B, n_det_t, n_el, n_el]
    orbs = wf(phys_conf, return_mos=True)  # per spin [B, n_det, n_spin, n_orb]
    n_det, n_orb_up = orbs[0].shape[-3], orbs[0].shape[-1]
    target = target.repeat(1, math.ceil(n_det / target.shape[-3]), 1, 1)[:, :n_det]
    n_up = hamil.n_up
    target = (target[..., :n_up, :n_up], target[..., n_up:, n_up:])
    if n_orb_up != n_up:
        target = (torch.nn.functional.pad(target[0], (0, n_orb_up - n_up)),
                  torch.nn.functional.pad(target[1], (n_up, 0)))
    losses = [(o - t) ** 2 for o, t in zip(orbs, target)]
    loss = sum(x.mean() for x in losses)
    per_sample_losses = sum(x.mean((-3, -2, -1)) for x in losses)
    return loss, per_sample_losses


def pretrain(
    gen,
    hamil,
    wf,
    opt: GradientTransformation,
    molecule_idx_sampler,
    sampler,
    smpl_state,
    dataset,
    *,
    steps,
):
    """Generator yielding ``(step, per_sample_losses [m, S, B], mol_idxs)``;
    the parameters of ``wf`` (a module or a :class:`~..wf.StateStack`) are
    updated in place by ``opt`` (``adam`` or ``lamb`` of :mod:`..optimizer`).
    ``gen`` draws the moves."""
    r = smpl_state['elec']['r']
    target_fn = PretrainTarget(hamil, None, dataset['centers'], dataset['shells'],
                               dataset['mo_coeffs'], dtype=r.dtype, device=r.device)
    states = wf_states(wf)
    confs = dataset['confs']  # [n_mols, n_states, n_det, n_el]
    conf_coeffs = dataset['conf_coeffs']
    if len(states) == 1:
        confs, conf_coeffs = confs[:, 0], conf_coeffs[:, 0]
        opt_state = opt.init(dict(states[0].named_parameters()))
    else:
        opt_state = opt.init(_stacked(states))
    first = True
    for step in steps:
        mol_idxs = molecule_idx_sampler.sample()
        t0 = time.perf_counter()
        with torch.no_grad():
            smpl_state, phys_conf, _ = sampler.sample(gen, smpl_state, mol_idxs)
        m, S, B = phys_conf.r.shape[:3]
        flat = [phys_conf.state(s) for s in range(S)]  # each [m * B], R per walker for m > 1
        if S > 1:  # pretrain_update's layout of several states: [S, m * B]
            flat = [flat[0].replace(r=torch.stack([c.r for c in flat]),
                                    mol_idx=torch.stack([c.mol_idx for c in flat]))]
        opt_state, _, per_sample_losses = pretrain_update(
            hamil, wf, target_fn, confs, conf_coeffs, flat[0], opt, opt_state)
        if first:
            log.info(f'First pretraining step done in {time.perf_counter() - t0:.1f}s')
            first = False
        yield step, per_sample_losses.view(S, m, B).transpose(0, 1), mol_idxs


def _stacked(states, tensors=None) -> dict:
    """Each parameter name -> the states' tensors stacked (the parameters'
    values by default)."""
    tensors = tensors or [dict(s.named_parameters()) for s in states]
    return {k: torch.stack([t[k].detach() for t in tensors]) for k in tensors[0]}


def pretrain_update(hamil, wf, target_fn, confs, conf_coeffs, phys_conf, opt, opt_state, *,
                    walker_chunk=None):
    """One update of the parameters of ``wf`` (in place) on the walkers
    ``phys_conf`` (of one molecule, or a flat batch of several with ``R``
    per walker); ``(opt_state, loss, per_sample_losses)``.  For one state
    ``confs`` is ``[n_mols, n_det, n_el]``, the optimizer's state that of the
    module's parameters and the losses ``[B]``; for S > 1 states the walkers,
    ``confs`` (``[n_mols, S, n_det, n_el]``) and the losses (``[S, B]``) have a
    state axis, and the optimizer's state is that of the stacked parameters.

    The gradient runs in sequential chunks of the walkers, the largest
    divisor of B at most ``walker_chunk`` (None reads
    ``DEEPQMC_TPU_GRAD_WALKER_CHUNK``, 0 for none): the loss is a mean over
    the walkers, so with chunks of one size it is the mean of the chunks'
    losses and its gradient the mean of their gradients.  With walkers
    sharded over processes the gradient is the mean of the ranks'."""
    states = wf_states(wf)
    multi = len(states) > 1
    params = [dict(s.named_parameters()) for s in states]
    flat = [p for ps in params for p in ps.values()]
    B = phys_conf.r.shape[-3]
    size = chunk_size(B, walker_chunk, 'DEEPQMC_TPU_GRAD_WALKER_CHUNK')
    grad_sum, losses, per_sample = None, [], []
    for i in range(0, B, size):
        rs, idxs = phys_conf.r[..., i:i + size, :, :], phys_conf.mol_idx[..., i:i + size]
        R = phys_conf.R[i:i + size] if phys_conf.R.dim() == 3 else phys_conf.R
        if multi:
            inputs = [(confs[:, s], conf_coeffs[:, s], PhysicalConfiguration(R, r, m))
                      for s, (r, m) in enumerate(zip(rs, idxs))]
        else:
            inputs = [(confs, conf_coeffs, PhysicalConfiguration(R, rs, idxs))]
        loss_c, per_sample_c = zip(*(pretrain_loss(hamil, s, target_fn, *x)
                                     for s, x in zip(states, inputs)))
        loss = sum(loss_c) / len(states)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, torch.autograd.grad(loss, flat, allow_unused=True))]
        grad_sum = grads if grad_sum is None else [a + g for a, g in zip(grad_sum, grads)]
        losses.append(loss.detach())
        per_sample.append(torch.stack(per_sample_c).detach())
    n = len(losses) * get_process_count()
    flat_grads = iter(g / n for g in sum_over_ranks(grad_sum))
    grads = [{k: next(flat_grads) for k in ps} for ps in params]
    with torch.no_grad():
        if multi:
            updates, opt_state = opt.update(_stacked(states, grads), opt_state, _stacked(states))
        else:
            updates, opt_state = opt.update(grads[0], opt_state, params[0])
            updates = {k: u[None] for k, u in updates.items()}
        for i, ps in enumerate(params):
            for k, p in ps.items():
                p.add_(updates[k][i])
    per_sample = torch.cat(per_sample, -1)
    return opt_state, torch.stack(losses).mean(), per_sample if multi else per_sample[0]
