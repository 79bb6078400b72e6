"""Where an evaluation or a training step's time goes on the card.

    python -m deepqmc_tpu_torch.profile_eval [--block-kernel] [--train]
        [--ansatz psiformer|ferminet|default] [--walkers N] [--sampler RECIPE]

Builds the H2O PsiFormer (or ``--ansatz``'s preset) at full width with
seeded weights (with ``--block-kernel``, each PsiFormer layer's forward
Laplacian is one launch of the fused block kernel instead of the per-op
rules), equilibrates 2048 walkers (``--walkers``) with one evaluation step,
then profiles one step's two halves separately with ``torch.profiler``: a
sample call (bench.py's 10 Metropolis moves, or the ``sampling.RECIPES``
entry ``--sampler``) and the forward-Laplacian local energy.  For each half it prints the wall
time (CUDA-synchronised), the summed device time of its kernels, the device's
idle share (1 - device time / wall time) and the kernels that take the most
device time.

With ``--train`` it instead takes 6 KFAC training steps (``train``, the
JAX package's bench.py settings) and profiles the parts a training step adds,
through the calls ``train_step`` makes: the gradient and taps, the KFAC
update with carried inverses and on a step that refreshes them; then it
times 10 refreshing updates by the host clock and CUDA events, to show
whether a slow one is device work or the device waiting.  Needs a GPU.
"""

import argparse
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import Molecule, MolecularHamiltonian, ansatz_preset, evaluate
from .fit import (
    DEFAULT_OPT_KWARGS,
    electron_grad_mode,
    electron_sampler,
    molecule_state,
    train,
)
from .kfac import KFAC
from .loss import create_loss_fn, median_log_squeeze_and_mask
from .sampling import MetropolisSampler

__all__ = ['main']


def _profiled(label, fn, top=12):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    events = [e for e in prof.key_averages() if e.device_type.name == 'CUDA']
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f'{label}: wall {wall_ms:.1f} ms, device {device_ms:.1f} ms, '
          f'idle share {1 - device_ms / wall_ms:.3f}, {sum(e.count for e in events)} kernel '
          f'launches', flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f'  {e.self_device_time_total / 1e3:8.2f} ms  {e.count:5d}x  {e.key[:110]}',
              flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--block-kernel', action='store_true',
                        help="one fused kernel launch per layer's forward Laplacian")
    parser.add_argument('--train', action='store_true',
                        help='profile the parts a KFAC training step adds')
    parser.add_argument('--ansatz', default='psiformer', choices=['psiformer', 'ferminet',
                                                                  'default'])
    parser.add_argument('--walkers', type=int, default=2048)
    parser.add_argument('--sampler', default=None, help='a sampling.RECIPES name')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_eval: needs a GPU', file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)
    hamil = MolecularHamiltonian(mol=Molecule.from_name('H2O'))
    kwargs = {'block_kernel': True} if args.block_kernel else {}
    wf = ansatz_preset(args.ansatz, seed=0, **kwargs)(hamil)
    n = args.walkers
    if args.train:
        _profile_training(hamil, wf, n, args.sampler)
        return 0
    *_, (_, state, _, _) = evaluate(hamil, wf, n_walkers=n, steps=1, seed=0, sampler=args.sampler)
    R, state = molecule_state(state)
    sampler = electron_sampler(args.sampler, 10)(hamil, wf)
    gen = torch.Generator('cuda').manual_seed(2)
    with electron_grad_mode(sampler, inference=True)():
        _, pc, _ = sampler.sample(gen, state, R)
        _profiled(f'sampling ({args.sampler or "10 Metropolis moves"})',
                  lambda: sampler.sample(gen, state, R))
    with torch.inference_mode():
        hamil.local_energy(wf, pc)  # warm-up of this shape
        _profiled('local energy (forward Laplacian)', lambda: hamil.local_energy(wf, pc))
    return 0


def _profile_training(hamil, wf, n, sampler):
    *_, (_, state, _, _) = train(hamil, wf, n_walkers=n, steps=6, seed=0, sampler=sampler)
    R, elec = molecule_state(state.sampler)
    loss = create_loss_fn(hamil, wf, median_log_squeeze_and_mask)
    kfac = KFAC(loss, **DEFAULT_OPT_KWARGS['kfac'])
    pc = MetropolisSampler.phys_conf(R, elec['r'])
    kfac.init(pc)
    opt_state, weight = state.opt, torch.ones(n, device='cuda')
    terms = loss.terms(pc, weight)
    grads, sums = loss.grad_and_taps(pc, weight, terms, taps=True)  # warm-up
    _profiled('gradient and taps', lambda: loss.grad_and_taps(pc, weight, terms, taps=True))
    period = kfac.inverse_update_period

    def update(step):
        kfac.update({**opt_state, 'step': step}, grads, sums, n)

    _profiled('KFAC update, inverses carried', lambda: update(period + 1))
    _profiled('KFAC update, inverses refreshed', lambda: update(period))
    for i in range(10):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        start.record()
        update(period)
        stop.record()
        stop.synchronize()
        print(f'refreshing update {i}: host {1e3 * (time.monotonic() - t0):.2f} ms, '
              f'CUDA events {start.elapsed_time(stop):.2f} ms', flush=True)


if __name__ == '__main__':
    sys.exit(main())
