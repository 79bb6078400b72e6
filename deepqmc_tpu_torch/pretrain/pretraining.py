"""Supervised pretraining of the ansatz orbitals to the SCF baseline
(counterpart of ``deepqmc_tpu/pretrain/pretraining.py``), one molecule a step
and one electronic state.

A step draws a molecule, moves its walkers with the sampler (no grad), and
updates the parameters by the gradient of the mean squared difference
between the ansatz's orbitals (``wf(phys_conf, return_mos=True)``) and the
SCF target's.  As in the JAX package the sampler's cached psi is never
refreshed after an update.  Not ported yet: the walker chunks of the
gradient (``DEEPQMC_TPU_GRAD_WALKER_CHUNK``; ROADMAP.md, queue 1 item 1).
"""

import logging
import math
import time

import torch

from ..fit import molecule_conf
from ..optimizer import GradientTransformation
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
    """Generator yielding ``(step, per_sample_losses [1, 1, B], mol_idxs)``;
    the parameters of ``wf`` are updated in place by ``opt`` (``adam`` or
    ``lamb`` of :mod:`..optimizer`).  ``gen`` draws the moves."""
    r = smpl_state['elec']['r']
    target_fn = PretrainTarget(hamil, None, dataset['centers'], dataset['shells'],
                               dataset['mo_coeffs'], dtype=r.dtype, device=r.device)
    confs = dataset['confs'][:, 0]  # [n_mols, n_det, n_el]: the one state
    conf_coeffs = dataset['conf_coeffs'][:, 0]
    opt_state = opt.init(dict(wf.named_parameters()))
    first = True
    for step in steps:
        mol_idxs = molecule_idx_sampler.sample()
        t0 = time.perf_counter()
        with torch.no_grad():
            smpl_state, phys_conf, _ = sampler.sample(gen, smpl_state, mol_idxs)
        opt_state, _, per_sample_losses = pretrain_update(
            hamil, wf, target_fn, confs, conf_coeffs, molecule_conf(phys_conf), opt, opt_state)
        if first:
            log.info(f'First pretraining step done in {time.perf_counter() - t0:.1f}s')
            first = False
        yield step, per_sample_losses[None, None], mol_idxs


def pretrain_update(hamil, wf, target_fn, confs, conf_coeffs, phys_conf, opt, opt_state):
    """One update of the parameters of ``wf`` (in place) on one molecule's
    walkers; ``(opt_state, loss, per_sample_losses [B])``."""
    params = dict(wf.named_parameters())
    loss, per_sample_losses = pretrain_loss(hamil, wf, target_fn, confs, conf_coeffs, phys_conf)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        for k, p in params.items():
            p.add_(updates[k])
    return opt_state, loss.detach(), per_sample_losses.detach()
