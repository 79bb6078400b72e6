"""The evaluation step (counterpart of the ``NoOptimizer`` branch of
``deepqmc_tpu/fit.py``'s step body) and the :func:`evaluate` loop over it.

One step: ``decorr`` Metropolis moves of the walkers, the local energy of the
new walkers via the forward Laplacian, the ``local_energy/*`` statistics and
the EWM estimators of the energy and its spread.  Evaluation leaves the
parameters alone, so the sampler's psi cache needs no refresh.
"""

from collections.abc import Iterator

import torch

from .ewm import init_ewm
from .sampling import DecorrSampler, MetropolisSampler
from .utils import resolve_device, set_true_fp32

__all__ = ['eval_step', 'evaluate']


def eval_step(gen, hamil, wf, sampler, state, R, ewm, std_ewm, update_ewm):
    """One evaluation step; returns (state, ewm, std_ewm, E_loc [B], stats)."""
    state, phys_conf, stats = sampler.sample(gen, state, R)
    E_loc, hamil_stats = hamil.local_energy(wf, phys_conf)
    stats = {
        **{k: v.mean() for k, v in hamil_stats.items()},
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
    return state, ewm, std_ewm, E_loc, stats


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
