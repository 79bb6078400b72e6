"""The step of ``deepqmc_tpu/fit.py`` (``step_body``) for one molecule and one
electronic state: the evaluation step with the :func:`evaluate` loop over it,
and the training step with the :func:`train` loop.

An evaluation step: ``decorr`` Metropolis moves of the walkers, the local
energy of the new walkers via the forward Laplacian, the ``local_energy/*``
statistics and the EWM estimators of the energy and its spread.  Evaluation
leaves the parameters alone, so the sampler's psi cache needs no refresh.

A training step: the same moves, unit weights, the optimizer's step (the local
energy, the clipped VMC gradient by one backward pass of log|psi|, and the
KFAC or Adam update of the parameters), then the sampler's psi refresh
under the new parameters, and the same statistics.
"""

from collections.abc import Iterator
from typing import NamedTuple

import torch

from .ewm import init_ewm
from .loss import create_loss_fn, median_log_squeeze_and_mask
from .optimizer import AdamOptimizer, KFACOptimizer, NoOptimizer
from .sampling import DecorrSampler, MetropolisSampler
from .utils import ConstantSchedule, InverseSchedule, resolve_device, set_true_fp32

__all__ = ['TrainState', 'eval_step', 'evaluate', 'train', 'train_step']

OPTIMIZERS = {'kfac': KFACOptimizer, 'adam': AdamOptimizer, 'none': NoOptimizer}
# the JAX package's bench.py settings: KFAC as bench.py:130-139, Adam at 1e-3
DEFAULT_OPT_KWARGS = {
    'kfac': dict(learning_rate_schedule=InverseSchedule(0.05, 10000),
                 damping_schedule=ConstantSchedule(1e-3), norm_constraint=1e-3),
    'adam': dict(lr=1e-3),
    'none': {},
}


class TrainState(NamedTuple):
    """The sampler's state and the optimizer's; the parameters live in the wave function."""

    sampler: dict
    opt: object


def eval_step(gen, hamil, wf, sampler, state, R, ewm, std_ewm, update_ewm):
    """One evaluation step; returns (state, ewm, std_ewm, E_loc [B], stats)."""
    state, phys_conf, stats = sampler.sample(gen, state, R)
    E_loc, hamil_stats = hamil.local_energy(wf, phys_conf)
    stats = {**{k: v.mean() for k, v in hamil_stats.items()}, **stats}
    ewm, std_ewm, stats = _energy_stats(E_loc, stats, ewm, std_ewm, update_ewm)
    return state, ewm, std_ewm, E_loc, stats


def _energy_stats(E_loc, stats, ewm, std_ewm, update_ewm):
    """The ``local_energy/*`` statistics and the EWMs of the energy and its spread."""
    stats = {
        **stats,
        'local_energy/mean': E_loc.mean(),
        'local_energy/std': E_loc.std(correction=0),
        'local_energy/min': E_loc.min(),
        'local_energy/max': E_loc.max(),
    }
    ewm = update_ewm(stats['local_energy/mean'], ewm)
    std_ewm = update_ewm(stats['local_energy/std'], std_ewm)
    stats |= {
        'energy/ewm': ewm.mean,
        'energy/ewm_error': torch.sqrt(ewm.sqerr),
        'energy/std_ewm': std_ewm.mean,
    }
    return ewm, std_ewm, stats


def train_step(gen, sampler, opt, train_state: TrainState, R, ewm, std_ewm, update_ewm):
    """One training step; returns (train_state, ewm, std_ewm, E_loc [B], stats)."""
    with torch.no_grad():
        smpl_state, phys_conf, smpl_stats = sampler.sample(gen, train_state.sampler, R)
    weight = torch.ones(len(phys_conf.r), dtype=R.dtype, device=R.device)
    opt_state, E_loc, stats = opt.step(train_state.opt, phys_conf, weight)
    if not isinstance(opt, NoOptimizer):
        with torch.no_grad():  # the parameters changed: refresh the cached psi
            smpl_state = sampler.update(smpl_state, R)
    ewm, std_ewm, stats = _energy_stats(
        E_loc, {**stats, **smpl_stats}, ewm, std_ewm, update_ewm
    )
    return TrainState(smpl_state, opt_state), ewm, std_ewm, E_loc, stats


def evaluate(
    hamil, wf, *, n_walkers: int = 2048, steps: int = 3, decorr: int = 10, seed: int = 0,
    device=None,
) -> Iterator[tuple[int, dict, torch.Tensor, dict]]:
    """Evaluate ``wf`` on ``hamil``: yields ``(step, sampler_state, E_loc, stats)``.

    Runs on ``device`` (``None`` means CUDA, and raises where it is absent) in
    float32, with TF32 off.  Walkers start from ``hamil.init_sample`` drawn
    on the CPU from ``seed``; the Metropolis moves draw from a generator on the
    device seeded with ``seed + 1``.  Each step runs under
    ``torch.inference_mode()``.
    """
    device = resolve_device(device)
    if device.type == 'cuda':
        set_true_fp32()
    wf = wf.to(device=device, dtype=torch.float32)
    R = torch.as_tensor(hamil.mol.coords, dtype=torch.float32, device=device)
    sampler = DecorrSampler(length=decorr).wrap(MetropolisSampler(hamil, wf))
    gen = torch.Generator(device).manual_seed(seed + 1)
    ewm, update_ewm = init_ewm(device=device)
    std_ewm = ewm
    with torch.inference_mode():
        state = sampler.init(torch.Generator().manual_seed(seed), n_walkers, R)
    for step in range(steps):
        with torch.inference_mode():
            state, ewm, std_ewm, E_loc, stats = eval_step(
                gen, hamil, wf, sampler, state, R, ewm, std_ewm, update_ewm
            )
        yield step, state, E_loc, stats


def train(
    hamil, wf, *, n_walkers: int = 2048, steps: int = 10, decorr: int = 10, seed: int = 0,
    optimizer: str = 'kfac', device=None, **opt_kwargs,
) -> Iterator[tuple[int, TrainState, torch.Tensor, dict]]:
    """Train ``wf`` on ``hamil``: yields ``(step, train_state, E_loc, stats)``.

    ``optimizer`` is 'kfac' (default settings as the JAX package's bench.py:
    lr 0.05 / (1 + n / 10000), damping 1e-3, norm constraint 1e-3, inverses
    every 5 steps), 'adam' (lr 1e-3) or 'none'; ``opt_kwargs`` override them.
    The local energies are clipped by ``median_log_squeeze_and_mask``.
    Runs on ``device`` (``None`` means CUDA, and raises where it is absent) in
    float32 with TF32 off; ``wf`` is moved there and its parameters are
    updated in place.  Walkers start from ``hamil.init_sample`` drawn on the
    CPU from ``seed``; the Metropolis moves draw from a generator on the
    device seeded with ``seed + 1``.
    """
    device = resolve_device(device)
    if device.type == 'cuda':
        set_true_fp32()
    wf = wf.to(device=device, dtype=torch.float32)
    R = torch.as_tensor(hamil.mol.coords, dtype=torch.float32, device=device)
    sampler = DecorrSampler(length=decorr).wrap(MetropolisSampler(hamil, wf))
    loss = create_loss_fn(hamil, wf, median_log_squeeze_and_mask)
    opt = OPTIMIZERS[optimizer](loss, **(DEFAULT_OPT_KWARGS[optimizer] | opt_kwargs))
    gen = torch.Generator(device).manual_seed(seed + 1)
    ewm, update_ewm = init_ewm(device=device)
    std_ewm = ewm
    with torch.no_grad():
        smpl_state = sampler.init(torch.Generator().manual_seed(seed), n_walkers, R)
    train_state = TrainState(smpl_state, opt.init(sampler.phys_conf(R, smpl_state['r'])))
    for step in range(steps):
        train_state, ewm, std_ewm, E_loc, stats = train_step(
            gen, sampler, opt, train_state, R, ewm, std_ewm, update_ewm
        )
        yield step, train_state, E_loc, stats
