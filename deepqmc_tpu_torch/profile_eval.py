"""Where an evaluation or a training step's time goes on the card.

    python -m deepqmc_tpu_torch.profile_eval [--block-kernel] [--train]

Builds the H2O PsiFormer at full width with seeded weights (with
``--block-kernel``, each layer's forward Laplacian is one launch of the fused
block kernel instead of the per-op rules), equilibrates
2048 walkers with one evaluation step, then profiles one step's two halves
separately with ``torch.profiler``: the 10 Metropolis moves (plain forwards)
and the forward-Laplacian local energy.  For each half it prints the wall
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

from . import Molecule, MolecularHamiltonian, evaluate, psiformer_ansatz
from .fit import DEFAULT_OPT_KWARGS, molecule_state, train
from .kfac import KFAC
from .loss import create_loss_fn, median_log_squeeze_and_mask
from .sampling import DecorrSampler, MetropolisSampler

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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_eval: needs a GPU', file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)
    hamil = MolecularHamiltonian(mol=Molecule.from_name('H2O'))
    wf = psiformer_ansatz(hamil, seed=0, block_kernel=args.block_kernel)
    if args.train:
        _profile_training(hamil, wf)
        return 0
    *_, (_, state, _, _) = evaluate(hamil, wf, n_walkers=2048, steps=1, seed=0)
    R, state = molecule_state(state)
    sampler = DecorrSampler(length=10).wrap(MetropolisSampler(hamil, wf))
    gen = torch.Generator('cuda').manual_seed(2)
    with torch.inference_mode():
        _, pc, _ = sampler.sample(gen, state, R)
        hamil.local_energy(wf, pc)  # warm-up of this shape
        _profiled('sampling (10 Metropolis moves)', lambda: sampler.sample(gen, state, R))
        _profiled('local energy (forward Laplacian)', lambda: hamil.local_energy(wf, pc))
    return 0


def _profile_training(hamil, wf):
    *_, (_, state, _, _) = train(hamil, wf, n_walkers=2048, steps=6, seed=0)
    R, elec = molecule_state(state.sampler)
    loss = create_loss_fn(hamil, wf, median_log_squeeze_and_mask)
    kfac = KFAC(loss, **DEFAULT_OPT_KWARGS['kfac'])
    pc = MetropolisSampler.phys_conf(R, elec['r'])
    kfac.init(pc)
    opt_state, weight = state.opt, torch.ones(2048, device='cuda')
    _, E_loc, _ = loss.terms(pc, weight)
    grads, taps = loss.grad_and_taps(pc, weight, E_loc, taps=True)  # warm-up
    _profiled('gradient and taps', lambda: loss.grad_and_taps(pc, weight, E_loc, taps=True))
    period = kfac.inverse_update_period

    def update(step):
        kfac.update({**opt_state, 'step': step}, grads, taps, 2048)

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
