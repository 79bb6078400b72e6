"""The VMC loss with its direct gradient estimator (counterpart of
``deepqmc_tpu/loss/loss_function.py``), for one or more molecules a step and
one or more electronic states.

The loss is the weighted mean local energy, plus ``alpha`` times the overlap
penalty with more than one state and ``spin_penalty`` times the mean local
S^2 where it is set.  The wave function is one module (one state) or a
:class:`~..wf.StateStack`; every state axis of the JAX package is a loop
over the stack's modules here.  Internally the walkers' numbers have the JAX
package's ``[mol, state, walker]`` grid.  Each state's local energy and
pullback take one pass over its walkers of every molecule, flattened to
``[mol * walker]`` with the nuclei ``R`` per walker, as the JAX package's
``_state_phys_conf`` flattens them: the kernels' launches do not grow with
the molecule batch.

The gradient is estimated head-on, never by differentiating the
Hamiltonian.  Every term's gradient is linear in the per-walker tangents
``T = d log|psi|``; the transpose of that linear map is the per-walker
coefficient ``c[mol, state, walker]`` that one autograd backward pass of
``sum(c * log|psi|)`` per state pulls back to that state's parameters.  With
one state and no spin penalty ``c`` has a closed form
(:func:`~.energy.compute_mean_energy_cotangent`); otherwise the overlap
and spin terms couple the walkers of different states, and ``c`` is the
gradient of the assembled tangent with respect to ``T``, which for a linear
map is its exact transpose (the JAX package's ``jax.linear_transpose``).
For KFAC each state's forward is instrumented (:func:`nn.instrumented`) and
a second backward with the all-ones cotangent gives its dense layers'
output sensitivities, which the loss reduces at once with the layers'
inputs to KFAC's factor sums (sum a a^T, sum g g^T).

With walkers sharded over processes (:mod:`..parallel`) every statistic of
the loss is over the global walker axis, so each rank's ``c`` carries the
global normalisation: the ranks' gradients and factor sums add up, in one
``all_reduce``, to those of the whole batch, the same on every rank.

Two walker chunks bound the memory, each the largest divisor of the walkers
at most its setting (0: none): ``eloc_walker_chunk`` for the local energy
(:func:`~.energy.compute_local_energy`) and ``grad_walker_chunk`` for the
pullback, which runs the forward and its backward one chunk of walkers at a
time.  The gradient is linear in the per-walker cotangents, so the chunks'
gradients sum to it exactly, and the factor sums accumulate exactly too, so
the raw taps of the whole batch never exist at once.  Their defaults read
``DEEPQMC_TPU_ELOC_WALKER_CHUNK`` and ``DEEPQMC_TPU_GRAD_WALKER_CHUNK``, the
JAX package's variables.
"""

from typing import NamedTuple, Optional

import torch

from .. import tracing
from ..nn import dense_layer_paths, instrumented
from ..parallel import all_device_mean, get_process_count, sum_over_ranks
from ..types import PhysicalConfiguration
from ..utils import chunk_size, grad_precision_ctx, tree_map
from ..wf.base import wf_states
from .clip import clip_local_energy, clip_psi_ratio
from .energy import (
    compute_local_energy,
    compute_mean_energy,
    compute_mean_energy_cotangent,
    compute_mean_energy_tangent,
)
from .overlap import OverlapPenalty
from .spin import compute_mean_spin, compute_mean_spin_tangent, compute_spin_contributions

__all__ = ['Terms', 'VMCLoss', 'create_loss_fn', 'factor_sums']


class Terms(NamedTuple):
    """The forward half of the loss, on the ``[m, S, walker]`` grid:
    ``psi_ratio`` ``[m, S, S, B]`` (None for one state) and the local S^2
    ``spin`` (None without the spin penalty)."""

    loss: torch.Tensor
    local_energy: torch.Tensor
    psi_ratio: Optional[torch.Tensor]
    spin: Optional[torch.Tensor]
    stats: dict


class VMCLoss:
    """The loss of ``wf`` (a module, or a :class:`~..wf.StateStack`).

    The walkers ``phys_conf`` and their weights come in one of three
    layouts.  One molecule (``R`` ``[n_nuc, 3]``): the state axis in front
    for S > 1 states (``r`` ``[S, B, n, 3]``, ``mol_idx`` and ``weight`` ``[S,
    B]``), none for one.  A molecule batch (``R`` ``[m, n_nuc, 3]``): the
    whole grid, ``r`` ``[m, S, B, n, 3]``, ``mol_idx`` and ``weight`` ``[m, S,
    B]``.  ``data`` holds the EWMs ``energy_ewm`` and ``std_ewm`` (``[m, S]``)
    that the overlap penalty's scale and state order read; None stands for
    EWMs still in their warm-up (NaN).  Calling the loss gives ``(loss,
    (local_energy, psi_ratio, stats))``, each in the layout of the walkers
    (``psi_ratio`` ``[S, S, B]`` or ``[m, S, S, B]``, or None);
    :meth:`value_and_grad` adds the gradient, a dict keyed as
    ``named_parameters()`` of each state (a list of them for S > 1), and
    :meth:`value_grad_and_taps` the dense layers' factor sums as well.
    """

    def __init__(self, hamil, wf, clip_mask_fn, clip_mask_overlap_fn=None,
                 alpha: Optional[float] = None, spin_penalty: Optional[float] = None,
                 scale_overlap_by: Optional[str] = None, sort_states_by: Optional[str] = None,
                 min_gap_scale_factor: float = 0.1, eloc_walker_chunk: Optional[int] = None,
                 grad_walker_chunk: Optional[int] = None):
        self.hamil, self.wf, self.clip_mask_fn = hamil, wf, clip_mask_fn
        self.eloc_walker_chunk, self.grad_walker_chunk = eloc_walker_chunk, grad_walker_chunk
        self.states = wf_states(wf)
        self.multi = len(self.states) > 1  # the walkers carry a state axis
        self.clip_mask_overlap_fn = clip_mask_overlap_fn
        self.alpha, self.spin_penalty = alpha, spin_penalty
        self.sort_states_by = sort_states_by
        self.overlap_penalty = OverlapPenalty(scale_overlap_by, min_gap_scale_factor)
        self.dense_paths = [dense_layer_paths(s) for s in self.states]

    # -- layouts ---------------------------------------------------------------

    @staticmethod
    def is_grid(phys_conf) -> bool:
        """Whether the walkers come as a molecule batch's grid."""
        return phys_conf.R.dim() == 3

    def grid_conf(self, phys_conf) -> PhysicalConfiguration:
        """The walkers as the ``[m, S, B]`` grid."""
        if self.is_grid(phys_conf):
            return phys_conf
        lead = (None,) if self.multi else (None, None)
        return PhysicalConfiguration(phys_conf.R[None], phys_conf.r[lead],
                                     phys_conf.mol_idx[lead])

    def _confs(self, phys_conf):
        """(the walkers' grid, each state's walkers as one flat batch)."""
        grid = self.grid_conf(phys_conf)
        return grid, [grid.state(s) for s in range(grid.r.shape[1])]

    def _grid(self, weight):
        if weight.dim() == 3:
            return weight
        return weight[None] if self.multi else weight[None, None]

    def n_walkers(self, weight) -> int:
        """The walkers of one state over every molecule and rank."""
        m = weight.shape[0] if weight.dim() == 3 else 1
        return m * weight.shape[-1] * get_process_count()

    def _data(self, data, like):
        if data is not None:
            return data
        nan = torch.full((1, len(self.states)), float('nan'), dtype=like.dtype, device=like.device)
        return {'energy_ewm': nan, 'std_ewm': nan}

    def _state_ordering(self, data) -> torch.Tensor:
        energy_ewm = data['energy_ewm']
        if self.sort_states_by == 'energy':
            return torch.argsort(energy_ewm, dim=-1, stable=True)
        return torch.arange(energy_ewm.shape[-1], device=energy_ewm.device).expand(
            energy_ewm.shape)

    # -- the forward half ------------------------------------------------------

    def terms(self, phys_conf, weight, data=None) -> Terms:
        """The loss, local energies, penalty inputs and stats: no autograd."""
        grid, confs = self._confs(phys_conf)
        w = self._grid(weight)
        m = grid.r.shape[0]
        per_state = [compute_local_energy(self.hamil, wf, pc, walker_chunk=self.eloc_walker_chunk)
                     for wf, pc in zip(self.states, confs)]
        local_energy = torch.stack([e.view(m, -1) for e, _ in per_state], 1)
        loss, stats = compute_mean_energy(local_energy, w)
        stats = {k: all_device_mean(torch.stack([s[k].view(m, -1) for _, s in per_state], 1), -1)
                 for k in per_state[0][1]}
        if not self.is_grid(phys_conf) and not self.multi:  # one walker batch: the means
            stats = {k: v[0, 0] for k, v in stats.items()}
        psi_ratio = spin = None
        if len(self.states) > 1:
            psi_ratio = self.overlap_penalty.ratios(self.states, grid)
            overlap, overlap_stats = self.overlap_penalty.value(psi_ratio, w)
            loss = loss + self.alpha * overlap
            stats |= overlap_stats
        if self.spin_penalty is not None:
            spin = compute_spin_contributions(self.hamil, self.states, confs, m)
            mean_spin, spin_stats = compute_mean_spin(spin, w)
            loss = loss + self.spin_penalty * mean_spin
            stats |= spin_stats
        return Terms(loss, local_energy, psi_ratio, spin, stats)

    def _aux(self, terms: Terms, phys_conf):
        """(local energies, ratios, stats) in the layout of the walkers
        ``phys_conf``: the grid's as they are, one molecule's without the
        molecule axis (and the state axis, for one state)."""
        E, ratio = terms.local_energy, terms.psi_ratio
        if self.is_grid(phys_conf):
            return E, ratio, terms.stats
        if not self.multi:
            return E[0, 0], None, terms.stats
        return E[0], None if ratio is None else ratio[0], terms.stats

    def __call__(self, phys_conf, weight, data=None):
        terms = self.terms(phys_conf, weight, data)
        return terms.loss, self._aux(terms, phys_conf)

    def value_and_grad(self, phys_conf, weight, data=None):
        terms = self.terms(phys_conf, weight, data)
        grads, _ = self.grad_and_taps(phys_conf, weight, terms, taps=False, data=data)
        return (terms.loss, self._aux(terms, phys_conf)), grads

    def value_grad_and_taps(self, phys_conf, weight, data=None):
        """Loss, gradient and the dense layers' taps as KFAC's factor sums:
        JAX path -> (sum a a^T, sum g g^T) over every row of every call
        (:func:`factor_sums`; a list per state for a stack)."""
        terms = self.terms(phys_conf, weight, data)
        grads, sums = self.grad_and_taps(phys_conf, weight, terms, taps=True, data=data)
        return (terms.loss, self._aux(terms, phys_conf)), grads, sums

    # -- the gradient half -----------------------------------------------------

    def cotangent(self, weight, terms: Terms, data=None) -> torch.Tensor:
        """The per-walker coefficients ``c`` ``[m, S, B]`` of the loss's gradient."""
        w = self._grid(weight)
        clipped, mask = clip_local_energy(self.clip_mask_fn, terms.local_energy)
        if len(self.states) == 1 and terms.spin is None:
            return compute_mean_energy_cotangent(clipped, w, mask)
        return self.transposed_cotangent(clipped, mask, w, terms, data)

    def transposed_cotangent(self, clipped, mask, w, terms: Terms, data=None) -> torch.Tensor:
        """``c`` as the gradient, with respect to ``T``, of the tangent
        assembled from every term (linear in ``T``, so this is its transpose)."""
        if terms.psi_ratio is not None:
            clipped_ratio, ratio_mask = clip_psi_ratio(self.clip_mask_overlap_fn, terms.psi_ratio)
            data = self._data(data, clipped)
            overlap_data = dict(data, ordering=self._state_ordering(data))

        def assemble_tangent(T):
            tangent = compute_mean_energy_tangent(clipped, w, T, mask)
            if terms.psi_ratio is not None:
                tangent = tangent + self.alpha * self.overlap_penalty.tangent(
                    clipped_ratio, w, T, ratio_mask, overlap_data)
            if terms.spin is not None:
                tangent = tangent + self.spin_penalty * compute_mean_spin_tangent(
                    terms.spin, w, T, mask)
            return tangent

        T = torch.zeros_like(clipped, requires_grad=True)
        with torch.enable_grad():
            (cot,) = torch.autograd.grad(assemble_tangent(T), T)
        return cot

    def grad_and_taps(self, phys_conf, weight, terms: Terms, *, taps: bool, data=None):
        """The gradient half: clip, form the per-walker cotangent, pull it back
        through each state's forward (with ``taps``, the factor sums as in
        :meth:`value_grad_and_taps`), summed over the ranks."""
        with tracing.span('grad'):
            cot = self.cotangent(weight, terms, data)
            _, confs = self._confs(phys_conf)
            grads, state_taps = [], []
            # each state's forward and backward and the taps' backward, at the
            # gradient's matmul precision (deepqmc_tpu/loss/loss_function.py)
            with grad_precision_ctx():
                for wf, paths, pc, c in zip(self.states, self.dense_paths, confs,
                                            cot.unbind(1)):
                    g, t = self._pull_back(wf, paths, pc, c.reshape(-1), taps)
                    grads.append(g)
                    state_taps.append(t)
            grads, state_taps = sum_over_ranks((grads, state_taps))
        if self.multi:
            return grads, state_taps if taps else None
        return grads[0], state_taps[0]

    def _pull_back(self, wf, dense_paths, phys_conf, cotangent, taps: bool):
        """(gradient, factor sums or None) of one state, in walker chunks of
        ``grad_walker_chunk``; both sum over the chunks."""
        B = len(cotangent)
        size = chunk_size(B, self.grad_walker_chunk, 'DEEPQMC_TPU_GRAD_WALKER_CHUNK')
        grads = sums = None
        for i in range(0, B, size):
            chunk = phys_conf.walkers(slice(i, i + size))
            g, t = self._pull_back_chunk(wf, dense_paths, chunk, cotangent[i:i + size], taps)
            grads = g if grads is None else tree_map(torch.add, grads, g)
            sums = t if sums is None else tree_map(torch.add, sums, t)
        return grads, sums

    def _pull_back_chunk(self, wf, dense_paths, phys_conf, cotangent, taps: bool):
        params = dict(wf.named_parameters())
        with torch.enable_grad():
            if not taps:
                log_psi = wf(phys_conf).log
                return self._grads(params, log_psi, cotangent, retain_graph=False), None
            with instrumented(wf) as rec:
                log_psi = wf(phys_conf).log
            grads = self._grads(params, log_psi, cotangent, retain_graph=True)
        with tracing.span('grad.taps'):
            calls = [(m, x, out) for m, xs in rec.calls.items() for x, out in xs]
            with torch.enable_grad():
                sens = torch.autograd.grad(
                    log_psi, [out for _, _, out in calls], torch.ones_like(log_psi),
                    allow_unused=True
                )
            return grads, factor_sums(dense_paths, calls, sens)

    @staticmethod
    def _grads(params, log_psi, cotangent, retain_graph):
        with tracing.span('grad.backward'):
            grads = torch.autograd.grad(
                log_psi, list(params.values()), cotangent, retain_graph=retain_graph,
                allow_unused=True,
            )
        return {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)
        }


def factor_sums(dense_paths, calls, sens):
    """KFAC's unnormalised factor sums (sum a a^T, sum g g^T) over the rows of
    the recorded dense-layer ``calls`` (module, input, output), by JAX path:
    ``a`` the input, with a ones column for a bias, ``g`` the output's
    sensitivity ``sens`` (None: zero).  A call without rows adds nothing, and
    a layer without any is left out, as KFAC leaves it to its generic rule."""
    sums = {}
    for (module, x, y), g in zip(calls, sens):
        a = x.reshape(-1, x.shape[-1])
        if not len(a):
            continue
        g = (torch.zeros_like(y) if g is None else g).reshape(-1, y.shape[-1])
        if getattr(module, 'b', None) is not None:
            a = torch.cat([a, a.new_ones(len(a), 1)], -1)
        A, G = sums.get(dense_paths[module], (0, 0))
        sums[dense_paths[module]] = (A + a.T @ a, G + g.T @ g)
    return sums


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
    eloc_walker_chunk: Optional[int] = None,
    grad_walker_chunk: Optional[int] = None,
) -> VMCLoss:
    """Build the VMC loss, with the JAX package's signature and the two walker
    chunks.  The overlap options act with more than one electronic state, as
    in the JAX package, where ``alpha`` and ``clip_mask_overlap_fn`` must be given."""
    n_states = len(wf_states(wf))
    if n_states > 1 and (alpha is None or clip_mask_overlap_fn is None):
        raise ValueError(f'{n_states} electronic states need alpha and clip_mask_overlap_fn')
    return VMCLoss(hamil, wf, clip_mask_fn, clip_mask_overlap_fn=clip_mask_overlap_fn,
                   alpha=alpha, spin_penalty=spin_penalty, scale_overlap_by=scale_overlap_by,
                   sort_states_by=sort_states_by, min_gap_scale_factor=min_gap_scale_factor,
                   eloc_walker_chunk=eloc_walker_chunk, grad_walker_chunk=grad_walker_chunk)
