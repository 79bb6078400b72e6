"""One run of a cell with the port's own spans on, read against the device trace.

    python3 qmcbench/program_trace.py --workload <cell> --seed <n> --seconds <s>
    python3 qmcbench/program_trace.py --workload <cell> --seed <n> --seconds <s> --cost 1

The benchmark's set-up (``harness.Run``, without the harness's outside
spans), then the window as ``--trace 1`` takes it: the first ``trace_steps``
steps under the device-only profiler, whole steps until ``--seconds`` have
passed, with ``deepqmc_tpu_torch.tracing`` on from the window's start to its
end.  Prints one JSON line: the readers of ``metrics/`` that read the
program's spans (``ctx['program']``, ``qmcbench/program_spans.py``), the
idle share as ``metrics/idle_share.py`` reads it, the layers' idle and the
unattributed idle in % of the profiled window (they sum to the idle share),
the idle gaps labelled by the program's innermost span, and
``tracing.summary()`` of the window.  No check runs.

With ``--cost 1`` nothing is profiled: the window takes blocks of
``inverse_update_period`` steps (5 for an evaluation) with tracing off and
on, in turns, and prints each mode's mean step ms over its blocks.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NEW_METRICS = ('sampling_idle_ms', 'local_energy_idle_ms', 'grad_idle_ms', 'kfac_idle_ms',
               'fit_idle_ms', 'idle_unattributed', 'kfac_refresh_ms', 'host_syncs_per_step',
               'sampling_launches_per_move')
TRAIN_ONLY = ('grad_idle_ms', 'kfac_idle_ms', 'kfac_refresh_ms')
MODES = ('off', 'on')


def traced_window(run, seconds, traffic):
    """The readers' context of a window with the program's spans on."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from deepqmc_tpu_torch import tracing
    from qmcbench import program_spans
    from qmcbench.trace import read_profile

    cuda = run.device.type == 'cuda'
    times, n = [], traffic['trace_steps']
    tracing.reset()
    tracing.enable()
    start = time.perf_counter()
    first = run.n_step
    with profiler(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        w0, t0 = time.time_ns(), time.perf_counter()
        for _ in range(n):
            times.append(run.step())
        if cuda:
            torch.cuda.synchronize()
        t1, w1 = time.perf_counter(), time.time_ns()
    recs = tracing.records()
    host = [(r['start_ns'], r['end_ns'], r['name']) for r in recs if r['end_ns']]
    profile = read_profile(prof, t1 - t0, host)
    ops, calls = program_spans.device_ops(prof)
    while True:
        times.append(run.step())
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    tracing.disable()
    return {
        'suffix': 'train' if run.training else 'eval', 'step_s': times, 'window_s': window_s,
        'walkers': traffic['walkers'], 'profile': profile,
        'program': {'records': tracing.records(), 'traced_steps': list(range(first, first + n)),
                    'window_steps': list(range(first, run.n_step)), 'window_ns': [w0, w1],
                    'device': ops or None,
                    'launch_ns': {c: t[0] for c, t in calls.items()}},
    }


def report(ctx):
    from deepqmc_tpu_torch import tracing
    from qmcbench import harness, program_spans

    suffix, prog = ctx['suffix'], ctx['program']
    metrics = {}
    for name in NEW_METRICS:
        if suffix == 'eval' and name in TRAIN_ONLY:
            continue
        value = harness._reader(name)(ctx)
        if value is not None:
            metrics[f'{name}.{suffix}'] = value
    out = {'metrics': metrics, 'idle_share': harness._reader('idle_share')(ctx),
           'launch_events': bool(prog['launch_ns']), 'steps': len(ctx['step_s']),
           'walker_steps_per_s': ctx['walkers'] * len(ctx['step_s']) / ctx['window_s']}
    if prog['device']:
        w0, w1 = prog['window_ns']
        line = program_spans.skew_line(prog['device'], prog['launch_ns'])
        if line:  # the device's lag behind the host at the window's ends, us
            t0, lead0, slope = line
            out['device_lag_us'] = [1e-3 * max(0, lead0 + slope * (w - t0)) for w in (w0, w1)]
        total, charged = program_spans.idle_by_layer(prog['records'],
                                                     program_spans.aligned(prog), w0, w1)
        share = {k: 100 * v / (w1 - w0) for k, v in charged.items()}
        share['unattributed'] = 100 * (total - sum(charged.values())) / (w1 - w0)
        out |= {'idle_pct_of_window': share, 'idle_pct_sum': sum(share.values()),
                'idle_gaps': ctx['profile']['breakdown']['idle_gaps']}
    out['summary'] = tracing.summary(prog['records'], set(prog['window_steps']))
    return out


def cost_window(run, seconds, block):
    """Mean step ms of each mode over its blocks of ``block`` steps, in turns."""
    from deepqmc_tpu_torch import tracing

    blocks = {m: [] for m in MODES}
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        for mode in MODES:
            tracing.reset()
            if mode != 'off':
                tracing.enable()
            blocks[mode].append(1e3 * sum(run.step() for _ in range(block)) / block)
            tracing.disable()
    return {m: {'mean_ms': statistics.fmean(v), 'blocks': v} for m, v in blocks.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--cost', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from qmcbench import harness

    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print('program_trace: needs a CUDA device', file=sys.stderr)
        return 1
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.cost))
    result['device'] = torch.cuda.get_device_name(0)
    print(result.pop('summary', ''), file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(workload, seed, seconds, cost=False, device='cuda', spec=None):
    """The result of one run; ``spec`` replaces the cell's files (the tests'
    small sizes)."""
    import torch

    from qmcbench import harness

    cell, cfg, traffic, _ = spec or harness.cell_spec(workload)
    run = harness.Run(cfg, traffic, seed, device)
    run.setup()
    if run.device.type == 'cuda':
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    if cost:
        opt = traffic['optimizer']
        block = opt['inverse_update_period'] if opt else 5
        result = {'cost': cost_window(run, seconds, block), 'block_steps': block}
    else:
        result = report(traced_window(run, seconds, traffic))
    run.close()
    return {'workload': workload, 'seed': seed, 'setup_s': setup_s, **result}


if __name__ == '__main__':
    sys.exit(main())
