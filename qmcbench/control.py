"""The readings the check's limits are set from, on the card at a cell's size.

    python3 qmcbench/control.py --workload <cell> --seeds 1,2,3 --mode sound
        [--seconds S] [--out FILE]

For each seed, in one process (the kernels built once), the cell's set-up,
its warm-up steps and a window of ``--seconds`` (an evaluation cell needs
enough steps for its rows), then the check's numbers against the float64
reference.  Modes:

- ``sound``: the program as the configuration states it; also the control
  ``ref_tf32``, the reference computed in float32 with TF32 on, put in the
  program's place on the same inputs;
- ``tf32``: the program's own lower-precision path (every
  ``DEEPQMC_TPU_*_PRECISION`` switch at 'high', TF32);
- the faults of a training cell, planted in the program: ``half_batch``
  (the loss and its gradient over half the walkers), ``altered`` (one
  walker's local energy replaced by another's where it is produced) and
  ``frozen`` (the KFAC step leaves the parameters as they were).

Prints one JSON line per seed and mode.  Not part of a benchmark run.
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qmcbench import check, harness  # noqa: E402

PRECISION_SWITCHES = ('DEEPQMC_TPU_MATMUL_PRECISION', 'DEEPQMC_TPU_SAMPLING_PRECISION',
                      'DEEPQMC_TPU_GRAD_PRECISION')


@contextlib.contextmanager
def tf32_path():
    saved = {k: os.environ.get(k) for k in PRECISION_SWITCHES}
    os.environ.update(dict.fromkeys(PRECISION_SWITCHES, 'high'))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
        import torch

        torch.set_float32_matmul_precision('highest')


@contextlib.contextmanager
def half_batch():
    """The loss and its gradient over the first half of the walkers."""
    import torch

    import deepqmc_tpu_torch.loss.loss_function as lf

    mean, cot = lf.compute_mean_energy, lf.compute_mean_energy_cotangent

    def first_half(x):
        keep = torch.zeros_like(x, dtype=torch.bool)
        keep[..., :x.shape[-1] // 2] = True
        return keep

    lf.compute_mean_energy = lambda E, w: mean(E[..., :E.shape[-1] // 2], w[..., :w.shape[-1] // 2])
    lf.compute_mean_energy_cotangent = lambda E, w, mask: cot(E, w, mask & first_half(mask))
    try:
        yield
    finally:
        lf.compute_mean_energy, lf.compute_mean_energy_cotangent = mean, cot


@contextlib.contextmanager
def altered():
    """Walker 0's local energy replaced by walker 1's where it is produced."""
    import deepqmc_tpu_torch.fit as fit_module
    import deepqmc_tpu_torch.loss.loss_function as lf

    saved = [(m, m.compute_local_energy) for m in (fit_module, lf)]

    def wrong(fn):
        def compute(*args, **kwargs):
            E, stats = fn(*args, **kwargs)
            E = E.clone()
            E[0] = E[1]
            return E, stats
        return compute

    for m, fn in saved:
        m.compute_local_energy = wrong(fn)
    try:
        yield
    finally:
        for m, fn in saved:
            m.compute_local_energy = fn


@contextlib.contextmanager
def frozen():
    """The KFAC step computes its update and leaves the parameters alone."""
    import torch

    from deepqmc_tpu_torch.kfac import KFAC

    update = KFAC.update

    def no_step(self, opt_state, grads, sums, n_batch):
        params = [{k: p.detach().clone() for k, p in s.named_parameters()}
                  for s in self.loss.states]
        out = update(self, opt_state, grads, sums, n_batch)
        with torch.no_grad():
            for s, saved in zip(self.loss.states, params):
                for k, p in s.named_parameters():
                    p.copy_(saved[k])
        return out

    KFAC.update = no_step
    try:
        yield
    finally:
        KFAC.update = update


FAULTS = {'tf32': tf32_path, 'half_batch': half_batch, 'altered': altered, 'frozen': frozen}


def readings(spec, seed, seconds, mode, device='cuda', witness=False):
    """{mode: numbers} of one seed (with ``sound`` also ``ref_tf32`` and, with
    ``witness``, ``ref_f32``: the plain reference in float32 with TF32 off)."""
    import torch

    _, cfg, traffic, _ = spec
    with FAULTS[mode]() if mode in FAULTS else contextlib.nullcontext():
        run = harness.Run(cfg, traffic, seed, device)
        with run.patched():
            run.setup()
            harness.measure(run, seconds, False, cfg, traffic)
        data, prog = run.check_data()
        run.close()
    truth = check.reference_side(data, cfg, traffic, device)
    out = {mode: check.compare(prog, truth, data['P0'])}
    if traffic['optimizer'] is not None:
        out['worst'] = check.worst_leaves(prog, truth, data['P0'])
    if mode == 'sound':
        low = check.reference_side(data, cfg, traffic, device, torch.float32, tf32=True)
        out['ref_tf32'] = check.compare(low, truth, data['P0'])
        if 'worst' in out:
            out['ref_tf32_worst'] = check.worst_leaves(low, truth, data['P0'])
        if witness:  # the plain reference in float32, TF32 off: a second witness
            f32 = check.reference_side(data, cfg, traffic, device, torch.float32, tf32=False,
                                       with_f32=False)
            out['ref_f32'] = check.compare(f32, truth, data['P0'])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--mode', default='sound', choices=['sound', *FAULTS])
    parser.add_argument('--seconds', type=float, default=0.0)
    parser.add_argument('--out')
    parser.add_argument('--witness', action='store_true',
                        help='also the plain reference in float32 (TF32 off)')
    args = parser.parse_args(argv)
    harness.set_cache_dirs()
    spec = harness.cell_spec(args.workload)
    for seed in map(int, args.seeds.split(',')):
        t0 = time.perf_counter()
        for mode, numbers in readings(spec, seed, args.seconds, args.mode,
                                               witness=args.witness).items():
            line = json.dumps({'workload': args.workload, 'seed': seed, 'mode': mode,
                               'numbers': numbers, 's': time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, 'a') as f:
                    f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
