"""LiH convergence A/B of the precision levers and KFAC's inverse period.

The port of ``scripts/ab_lih_convergence.py``: the same variants with the same
switches (the JAX package's names and meanings), each a training run of the
port's command line on LiH (progression config 2: 1024 walkers, KFAC) for a
fixed step budget, then an evaluation from its last checkpoint.  It reports
the evaluation's mean energy with its error (the spread of the step means)
and the 10-MAD robust estimate, read as the JAX script reads them, and
appends one JSON line per variant to ``runs/ab_lih_convergence.jsonl``.  A
variant with a lever on is evaluated a second time with every lever off
(``LEVERS_OFF``, the ``*_levers_off`` keys): the levers also act on the
evaluation's local energy, so its energy mixes the trained wavefunction's
quality with the estimator's bias, and only the second one compares training
with ``baseline``.  A lever becomes a default of the port only once its
variant lands within the errors of ``baseline`` (true float32 everywhere) at
a matched budget on the card.  ``samp_bf16`` runs on the CPU only: the card
refuses the 'default' label (cuBLAS runs it as TF32).

    python -m deepqmc_tpu_torch.ab_lih_convergence [--steps N] [--variants a,b]
        [--seed S] [--device cpu]

The evaluation's local energies go to ``local_energy/NNNNNN.npy`` under its
workdir (:class:`SampleLogger`, numpy only: the card's machine has no h5py).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from .utils import flatten_dict

__all__ = ['LEVERS_OFF', 'VARIANTS', 'SampleLogger', 'final_energy', 'levers_on',
           'robust_energy']

# every pre-round-4 variant of the JAX script pins the round-4 levers off, so
# the names keep their meaning (the same switches, whatever the defaults)
_PRE_R4 = {'DEEPQMC_TPU_JAC_MATMUL': 'f32', 'DEEPQMC_TPU_GRAD_PRECISION': 'inherit'}
VARIANTS = {
    # true float32 everywhere, inverses every step: the control
    'baseline': {
        'env': {
            'DEEPQMC_TPU_SAMPLING_PRECISION': 'highest',
            'DEEPQMC_TPU_JAC_DTYPE': 'f32',
            **_PRE_R4,
        },
        'inv_period': 1,
    },
    'inv5': {
        'env': {'DEEPQMC_TPU_SAMPLING_PRECISION': 'highest', **_PRE_R4},
        'inv_period': 5,
    },
    'inv5_samphigh': {
        'env': {'DEEPQMC_TPU_SAMPLING_PRECISION': 'high', **_PRE_R4},
        'inv_period': 5,
    },
    'jac_bf16': {
        'env': {
            'DEEPQMC_TPU_SAMPLING_PRECISION': 'high',
            'DEEPQMC_TPU_JAC_DTYPE': 'bf16',
            **_PRE_R4,
        },
        'inv_period': 5,
    },
    'jacmm_bf16': {
        'env': {
            'DEEPQMC_TPU_SAMPLING_PRECISION': 'high',
            'DEEPQMC_TPU_JAC_DTYPE': 'bf16',
            'DEEPQMC_TPU_JAC_MATMUL': 'bf16',
        },
        'inv_period': 5,
    },
    'grad_high': {
        'env': {
            'DEEPQMC_TPU_SAMPLING_PRECISION': 'high',
            'DEEPQMC_TPU_JAC_DTYPE': 'bf16',
            'DEEPQMC_TPU_GRAD_PRECISION': 'high',
        },
        'inv_period': 5,
    },
    # every lever of the JAX package's accelerator defaults
    'r4_all': {
        'env': {
            'DEEPQMC_TPU_SAMPLING_PRECISION': 'high',
            'DEEPQMC_TPU_JAC_DTYPE': 'bf16',
            'DEEPQMC_TPU_JAC_MATMUL': 'bf16',
            'DEEPQMC_TPU_GRAD_PRECISION': 'high',
        },
        'inv_period': 5,
    },
    'samp_bf16': {
        'env': {
            'DEEPQMC_TPU_SAMPLING_PRECISION': 'default',
            'DEEPQMC_TPU_JAC_DTYPE': 'bf16',
            'DEEPQMC_TPU_JAC_MATMUL': 'bf16',
            'DEEPQMC_TPU_GRAD_PRECISION': 'high',
        },
        'inv_period': 5,
    },
}

REFERENCE = -8.07000  # LiH, the reference's tutorial (as the JAX script)
# every switch at true float32: the second evaluation of a variant with a lever on
LEVERS_OFF = {'DEEPQMC_TPU_SAMPLING_PRECISION': 'highest',
              'DEEPQMC_TPU_GRAD_PRECISION': 'highest', 'DEEPQMC_TPU_JAC_DTYPE': 'f32',
              'DEEPQMC_TPU_JAC_MATMUL': 'f32'}
SINKS_OFF = ['task.metric_logger_constructor=null']
SAMPLE_SINK = ['+task.h5_logger_constructor._target_='
               'deepqmc_tpu_torch.ab_lih_convergence.SampleLogger',
               '+task.h5_logger_constructor._partial_=true']


class SampleLogger:
    """A sink in the place of ``log.H5Logger`` that keeps each step's local
    energies, ``local_energy/NNNNNN.npy`` under the run's workdir."""

    def __init__(self, workdir: str, additional_keys_to_whitelist: Optional[list] = None, *,
                 keys_whitelist: Optional[list] = None, init_step: int = 0,
                 aux_data: Optional[dict] = None):
        self.dir = Path(workdir) / 'local_energy'
        self.dir.mkdir(parents=True, exist_ok=True)
        self.step = init_step

    def update(self, data: dict):
        samples = flatten_dict(data).get('local_energy/samples')
        if samples is not None:
            np.save(self.dir / f'{self.step:06d}.npy', np.asarray(samples))
        self.step += 1

    def close(self):
        pass


def _samples(workdir) -> np.ndarray:
    """The evaluation's local energies, ``[steps, ...]``."""
    files = sorted((Path(workdir) / 'evaluation' / 'local_energy').glob('*.npy'))
    if not files:
        raise FileNotFoundError(f'no local energies under {workdir}/evaluation/local_energy')
    return np.stack([np.load(f) for f in files])


def final_energy(workdir):
    """(mean, error) of the evaluation's local energies: the mean over every
    sample, the error the spread of the step means over sqrt(steps)."""
    e_loc = _samples(workdir)
    samples = e_loc.reshape(len(e_loc), -1)
    step_means = samples.mean(axis=1)
    return float(samples.mean()), float(step_means.std() / len(step_means) ** 0.5)


def robust_energy(workdir):
    """(mean, error) of the samples within 10 median absolute deviations of
    the median: one walker near a node can pull the raw mean by tens of mHa
    on a short budget."""
    e = _samples(workdir).reshape(-1)
    med = np.median(e)
    mad = np.median(np.abs(e - med))
    mask = np.abs(e - med) < 10 * mad
    return float(e[mask].mean()), float(e[mask].std() / mask.sum() ** 0.5)


def run(cmd, env_extra, timeout):
    env = dict(os.environ, **env_extra)
    print('+', ' '.join(cmd), env_extra, flush=True)
    proc = subprocess.run(cmd, env=env, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f'{cmd[2]} exited with {proc.returncode}')


def levers_on(env) -> bool:
    """Whether the switches ``env`` put any product or store below true
    float32 (unset switches are at the port's defaults, all true float32)."""
    return any(v not in ('highest', 'inherit', 'f32') for v in env.values())


def commands(wd, steps, eval_steps, pretrain_steps, inv_period, seed=None, device=None,
             extra=(), eval_suffix='_eval'):
    """(the training run's command line, the evaluation's) of one variant;
    the evaluation's workdir is ``wd`` with ``eval_suffix``."""
    base = [sys.executable, '-m', 'deepqmc_tpu_torch',
            *([f'--device={device}'] if device else [])]
    train = [*base, 'hamil/mol=LiH', 'task.electron_batch_size=1024', f'task.steps={steps}',
             f'task.pretrain_steps={pretrain_steps}', '+task.fit_block_size=10',
             f'task.opt.kfac.inverse_update_period={inv_period}',
             *([] if seed is None else [f'task.seed={seed}']),
             *SINKS_OFF, 'task.h5_logger_constructor=null', *extra, f'--workdir={wd}']
    evaluate = [*base, 'task=evaluate', f'task.restdir={wd}/training', f'+task.steps={eval_steps}',
                '+task.fit_block_size=10', '+task.metric_logger_constructor=null',
                *SAMPLE_SINK, f'--workdir={wd}{eval_suffix}']
    return train, evaluate


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--steps', type=int, default=1500)
    p.add_argument('--eval-steps', type=int, default=200)
    p.add_argument('--pretrain-steps', type=int, default=500)
    p.add_argument('--variants', default=None)
    p.add_argument('--workdir', default='runs/ab_lih')
    p.add_argument('--seed', type=int, default=None,
                   help='task.seed; the workdir and the row are suffixed with it')
    p.add_argument('--device', default=None, help='cpu to run on the CPU (default: the card)')
    p.add_argument('--out', default='runs/ab_lih_convergence.jsonl')
    p.add_argument('extra', nargs='*', help='further overrides of the training run')
    args = p.parse_args(argv)
    names = args.variants.split(',') if args.variants else list(VARIANTS)
    if args.device != 'cpu':
        refused = [n for n in names if 'default' in VARIANTS[n]['env'].values()]
        if refused:
            raise SystemExit(f'{", ".join(refused)}: the card refuses the precision label '
                             "'default' (cuBLAS runs it as TF32); run it with --device cpu")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for name in names:
        spec = VARIANTS[name]
        label = name if args.seed is None else f'{name}_seed{args.seed}'
        wd = Path(args.workdir) / label
        train, evaluate = commands(wd, args.steps, args.eval_steps, args.pretrain_steps,
                                   spec['inv_period'], args.seed, args.device, args.extra)
        t0 = time.time()
        run(train, spec['env'], timeout=7200)
        train_s = time.time() - t0
        run(evaluate, spec['env'], timeout=3600)
        energy, err = final_energy(f'{wd}_eval')
        energy_rob, err_rob = robust_energy(f'{wd}_eval')
        off = (energy, err, energy_rob, err_rob)
        if levers_on(spec['env']):
            _, evaluate_off = commands(wd, args.steps, args.eval_steps, args.pretrain_steps,
                                       spec['inv_period'], args.seed, args.device, args.extra,
                                       eval_suffix='_eval_off')
            run(evaluate_off, LEVERS_OFF, timeout=3600)
            off = (*final_energy(f'{wd}_eval_off'), *robust_energy(f'{wd}_eval_off'))
        row = {
            'variant': label, 'energy': energy, 'err': err,
            'dev_mha': (energy - REFERENCE) * 1e3,
            'energy_robust': energy_rob, 'err_robust': err_rob,
            'energy_levers_off': off[0], 'err_levers_off': off[1],
            'dev_mha_levers_off': (off[0] - REFERENCE) * 1e3,
            'energy_robust_levers_off': off[2], 'err_robust_levers_off': off[3],
            'steps': args.steps, 'eval_steps': args.eval_steps,
            'pretrain_steps': args.pretrain_steps, 'train_seconds': round(train_s),
            'env': spec['env'], 'inv_period': spec['inv_period'],
        }
        with open(out, 'a') as f:
            f.write(json.dumps(row) + '\n')
        print(json.dumps(row), flush=True)


if __name__ == '__main__':
    main()
