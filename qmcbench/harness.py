"""One run of a benchmark cell: set-up, the measured window, the check.

Everything a cell is made of is found by the names in ``BENCHMARK.json``:
the configuration's file (``configs/``), the traffic mix
(``traffic/<traffic>.json``), the limits of the check
(``limits/<cell>.json``) and a reader per metric (``metrics/<name>.py``, or
``metrics/<name before the first dot>.py``).

Set-up builds the port's ansatz from the configuration, draws its weights on
the device from the seed, draws the walkers with ``hamil.init_sample``, makes
the configuration's equilibration calls and starts
``deepqmc_tpu_torch.fit.fit_wf`` with the task's optimizer, sampler and
clipping as the port's conf tree gives them, ``block_size`` 1 and the default
observable monitors; its first steps (through a KFAC inverse refresh) are the
warm-up, and the first of them are the steps the check follows.  The window
then takes whole steps of that same loop until ``seconds`` have passed.
"""

import importlib.util
import itertools
import json
import math
import os
import re
import sys
import time
from contextlib import contextmanager
from functools import partial
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'deepqmc_tpu')
WIDTH_KEYS = {
    'psiformer': ('n_determinants', 'embedding_dim', 'n_interactions', 'num_heads'),
    'ferminet': ('n_determinants', 'embedding_dim', 'n_interactions',
                 'two_particle_stream_dim'),
}

__all__ = ['Run', 'cell_spec', 'forbidden_modules', 'main']


def log(message):
    print(f'qmcbench: {message}', file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(workload, bench=None):
    """(cell, configuration, traffic, limits) of the cell ``workload``."""
    bench = bench or load_json(ROOT / 'BENCHMARK.json')
    cell = next((w for w in bench['workloads'] if w['name'] == workload), None)
    if cell is None:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json')
    entry = next(c for c in bench['configs'] if c['name'] == cell['config'])
    return (cell, load_json(ROOT / entry['file']),
            load_json(BENCH / 'traffic' / f"{cell['traffic']}.json"),
            load_json(BENCH / 'limits' / f"{workload}.json"))


def seed_for(seed: int, tag: str) -> int:
    """A generator seed for one use, from the run's seed and a tag."""
    words = [seed % 2**64, *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0] >> 1)


def forbidden_modules():
    return sorted({name.split('.')[0] for name in sys.modules} & set(FORBIDDEN))


def _draw_scale(rule, shape):
    if rule['draw'] == 'normal_fan_in':
        return 1 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    if rule['draw'] == 'normal_fan_out':
        return 1 / math.sqrt(shape[-1])
    if rule['draw'] == 'one_plus':
        return rule['scale']
    raise ValueError(f"unknown weight draw {rule['draw']!r}")


def draw_weights(wf, rules, seed, device):
    """Every parameter of ``wf`` from one normal draw on ``device``, scaled
    by the first rule whose ``match`` finds the parameter's name."""
    import torch

    params = list(wf.named_parameters())
    gen = torch.Generator(device).manual_seed(seed_for(seed, 'weights'))
    flat = torch.randn(sum(p.numel() for _, p in params), generator=gen, device=device)
    offset = 0
    with torch.no_grad():
        for name, p in params:
            z = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
            rule = next(r for r in rules if re.search(r['match'], name))
            scale = _draw_scale(rule, p.shape)
            p.copy_(1 + scale * z if rule['draw'] == 'one_plus' else scale * z)


def _check_conf(traffic, sampler_node, opt_node):
    """The port's conf tree runs what the traffic file states."""
    samplers = sampler_node['elec_sampler']['samplers']
    stated = {'moves': samplers[0]['length'], 'tau': samplers[1]['tau'],
              'target_acceptance': samplers[1].get('target_acceptance')}
    if opt_node is not None:
        k = opt_node['kfac']
        stated |= {'learning_rate': k['learning_rate_schedule']['init_value'],
                   'decay_rate': k['learning_rate_schedule']['decay_rate'],
                   'damping': k['damping_schedule']['value'],
                   'norm_constraint': k['norm_constraint'],
                   'inverse_update_period': k['inverse_update_period']}
    given = {**traffic, **(traffic['optimizer'] or {})}
    wrong = {k: (v, given.get(k)) for k, v in stated.items() if given.get(k) != v}
    if wrong:
        raise SystemExit(f'the conf tree and the traffic file disagree: {wrong}')


class Run:
    """One run of a cell on ``device``; ``spans`` turns on the layer spans."""

    def __init__(self, config, traffic, seed, device='cuda', spans=False):
        import torch

        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.training = traffic['optimizer'] is not None
        from .trace import Spans

        self.spans = Spans(self.device) if spans else None
        self.cap = {'r': [], 'loss': [], 'E': [], 'rows': []}
        self.n_step = 0
        self.failed = 0

    def _span(self, name, fn, size_of=None):
        return self.spans.wrap(name, fn, size_of) if self.spans else fn

    @contextmanager
    def patched(self):
        """The local-energy entry of the port wrapped in a span, while the run lives."""
        import deepqmc_tpu_torch.fit as fit_module
        import deepqmc_tpu_torch.loss.loss_function as loss_module

        saved = [(m, m.compute_local_energy) for m in (fit_module, loss_module)]
        for m, fn in saved:
            m.compute_local_energy = self._span('local_energy', fn,
                                                lambda hamil, wf, pc, **_: pc.r.shape[0])
        try:
            yield
        finally:
            for m, fn in saved:
                m.compute_local_energy = fn

    # -- set-up -----------------------------------------------------------------

    def build(self):
        import torch

        import deepqmc_tpu_torch as dq
        from deepqmc_tpu_torch import conf, fit
        from deepqmc_tpu_torch.config import instantiate
        from deepqmc_tpu_torch.loss import create_loss_fn, median_clip_and_mask
        from deepqmc_tpu_torch.observable import default_observable_monitors
        from deepqmc_tpu_torch.optimizer import NoOptimizer
        from deepqmc_tpu_torch.sampling import initialize_sampler_state
        from deepqmc_tpu_torch.utils import set_true_fp32

        cfg, traffic, dev = self.cfg, self.traffic, self.device
        if dev.type == 'cuda':
            set_true_fp32()
        m = cfg['molecule']
        self.mol = dq.Molecule(coords=m['coords'], charges=m['charges'], charge=m['charge'],
                               spin=m['spin'], unit=m['unit'])
        self.hamil = hamil = dq.MolecularHamiltonian(mol=self.mol)
        widths = {k: cfg[k] for k in WIDTH_KEYS[cfg['ansatz']]}
        if cfg['precision']['block_kernel']:
            widths['block_kernel'] = True
        self.wf = wf = dq.ansatz_preset(cfg['ansatz'], **widths)(hamil).to(dev)
        draw_weights(wf, cfg['weights'], self.seed, dev)
        self.P0 = {k: v.detach().clone() for k, v in wf.state_dict().items()}

        sampler_node = conf.task.sampler_factory.OPTIONS[traffic['sampler']]
        opt_node = conf.task.opt.OPTIONS[traffic['optimizer']['conf']] if self.training else None
        _check_conf(traffic, sampler_node, opt_node)
        idx_sampler, sampler = instantiate(sampler_node)(
            torch.Generator().manual_seed(seed_for(self.seed, 'molecules')), hamil, wf,
            [self.mol], 1, 1)
        sampler.sample = self._span('sampling', sampler.sample)
        sampler.update = self._span('sampling', sampler.update)
        self.grad_mode = fit.sampling_grad_mode(sampler, inference=not self.training)
        with self.grad_mode():
            state = initialize_sampler_state(
                torch.Generator().manual_seed(seed_for(self.seed, 'walkers')), sampler,
                traffic['walkers'], [self.mol], dtype=torch.float32, device=dev)
        gen = torch.Generator(dev).manual_seed(seed_for(self.seed, 'moves'))
        for _, state, _, _ in fit._equilibration(gen, idx_sampler, sampler, state,
                                                 self.grad_mode, cfg['max_eq_steps'], False):
            pass

        clip_fn = partial(median_clip_and_mask, clip_width=traffic['clip']['width'],
                          median_center=traffic['clip']['median_center'])
        base_opt = instantiate(opt_node) if self.training else NoOptimizer
        self.fit = fit.fit_wf(
            gen, hamil, wf, partial(self._optimizer, base_opt), idx_sampler, sampler,
            itertools.count(), fit.TrainState(state, None, None),
            partial(self._loss, create_loss_fn, clip_fn), default_observable_monitors(),
            block_size=1, grad_mode=self.grad_mode)

    def _loss(self, create_loss_fn, clip_fn, hamil, wf):
        loss = create_loss_fn(hamil, wf, clip_fn)
        terms = loss.terms

        def captured_terms(phys_conf, weight, data=None):
            out = terms(phys_conf, weight, data)
            if self.training and len(self.cap['loss']) < self.traffic['checked_steps']:
                self.cap['r'].append(phys_conf.r.detach().reshape(-1, *phys_conf.r.shape[-2:])
                                     .clone())
                self.cap['loss'].append(out.loss.detach().clone())
                self.cap['E'].append(out.local_energy.detach().reshape(-1).clone())
            return out

        loss.terms = captured_terms
        loss.grad_and_taps = self._span('grad', loss.grad_and_taps)
        return loss

    def _optimizer(self, base, loss):
        opt = base(loss)
        if self.training:
            update = opt.kfac.update

            def captured_update(opt_state, grads, sums, n_batch):
                if 'grads' not in self.cap:
                    self.cap['grads'] = {k: g.detach().clone() for k, g in grads.items()}
                return update(opt_state, grads, sums, n_batch)

            opt.kfac.update = self._span('kfac', captured_update)
        return opt

    def step(self):
        """One step of the fit loop; returns its host seconds."""
        t0 = time.perf_counter()
        if self.spans:
            self.spans.step = self.n_step
        _, self.state, _, stats, samples = next(self.fit)
        seconds = time.perf_counter() - t0
        if self.spans:
            self.spans.step = None
        if not (np.isfinite(samples['psi/samples']['log']).all()
                and np.isfinite(samples['local_energy/samples']).all()):
            self.failed += 1
        if self.training and self.n_step == self.traffic['checked_steps'] - 1:
            self.P3 = {k: v.detach().clone() for k, v in self.wf.state_dict().items()}
        if not self.training and self.n_step >= self.traffic['warmup_steps']:
            self._keep_rows(samples)
        self.n_step += 1
        return seconds

    def _rows(self, count):
        import torch

        gen = torch.Generator().manual_seed(seed_for(self.seed, f'rows{self.n_step}'))
        return torch.randperm(self.traffic['walkers'], generator=gen)[:count]

    def _keep_rows(self, samples):
        idx = self._rows(self.traffic['rows_per_step'])
        r = self.state.sampler['elec']['r'][0, 0]
        self.cap['rows'].append((r[idx.to(r.device)].clone(), idx,
                                 samples['local_energy/samples'].reshape(-1),
                                 samples['psi/samples']['log'].reshape(-1),
                                 samples['psi/samples']['sign'].reshape(-1)))

    def setup(self):
        self.build()
        for _ in range(self.traffic['warmup_steps']):
            self.step()

    # -- after the window ---------------------------------------------------------

    def check_data(self):
        """The program's captures the check reads (on the CPU), and what the
        reference is given: the weights drawn, the walkers of the checked
        steps, the rows of the window."""
        import torch

        cpu = lambda t: t.detach().cpu()  # noqa: E731
        sample = np.random.default_rng(seed_for(self.seed, 'check'))
        data, prog = {'P0': {k: cpu(v) for k, v in self.P0.items()}}, {}
        if self.training:
            idx = self._rows(self.traffic['check_rows'])
            elec = self.state.sampler['elec']
            data |= {'r': [cpu(r) for r in self.cap['r']],
                     'P_final': {k: cpu(v) for k, v in self.wf.state_dict().items()},
                     'rows_r': cpu(elec['r'][0, 0][idx.to(self.device)])}
            psi = elec['psi']
            prog |= {'loss': [cpu(x) for x in self.cap['loss']],
                     'E': [cpu(x) for x in self.cap['E']],
                     'grads': {k: cpu(v) for k, v in self.cap['grads'].items()},
                     'P3': {k: cpu(v) for k, v in self.P3.items()},
                     'log': cpu(psi.log[0, 0][idx.to(self.device)]),
                     'sign': cpu(psi.sign[0, 0][idx.to(self.device)])}
        else:
            rows = self.cap['rows']
            r = torch.cat([cpu(x[0]) for x in rows])
            take = lambda j: torch.cat([torch.as_tensor(x[j][x[1].numpy()]) for x in rows])  # noqa: E731
            E, log, sign = take(2), take(3), take(4)
            pick = torch.as_tensor(sample.choice(len(r), min(len(r), self.traffic['check_rows']),
                                                 replace=False))
            data['rows_r'] = r[pick]
            prog |= {'E': [E[pick]], 'log': log[pick], 'sign': sign[pick]}
        return data, prog

    def close(self):
        """Free the program's state on the device."""
        import torch

        self.fit.close()
        for name in ('fit', 'wf', 'state', 'P0', 'P3', 'cap', 'hamil'):
            self.__dict__.pop(name, None)
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()


# -- the command ------------------------------------------------------------------


def _reader(name):
    for stem in (name, name.split('.')[0]):
        path = BENCH / 'metrics' / f'{stem}.py'
        if path.exists():
            spec = importlib.util.spec_from_file_location(f'qmcbench_metric_{stem}', path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise SystemExit(f'no reader for the metric {name!r} under metrics/')


def _metrics(entries, workload, ctx):
    out = {}
    for m in entries:
        if 'workloads' in m and workload not in m['workloads']:
            continue
        value = _reader(m['name'])(ctx)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def measure(run, seconds, trace, cfg, traffic):
    """The window: whole steps until ``seconds`` have passed.  With ``trace``
    the first ``trace_steps`` of them run under the profiler.  Returns the
    readers' context."""
    import torch

    from . import flops

    cuda = run.device.type == 'cuda'
    times, profile = [], None
    start = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiler

        from .trace import read_profile

        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profiler(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(traffic['trace_steps']):
                times.append(run.step())
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        profile = read_profile(prof, t1 - t0, run.spans.host)
        first = run.n_step - traffic['trace_steps']
        profile['eloc_walkers'] = [b for s, b in run.spans.calls['local_energy']
                                   if s >= first]
    while True:  # at least one step after the profiled ones
        times.append(run.step())
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    measured = times[traffic['trace_steps']:] if trace else times
    steps = []
    if run.spans:
        per_step = run.spans.per_step_ms()
        last = run.n_step - len(measured)
        steps = [{'host_ms': 1e3 * t, 'spans': dict(per_step.get(last + i, {}))}
                 for i, t in enumerate(measured)]
    return {
        'suffix': 'train' if run.training else 'eval', 'config': cfg, 'traffic': traffic,
        'flops': flops, 'step_s': times, 'measured_step_s': measured, 'window_s': window_s,
        'steps': steps, 'profile': profile,
    }


def run_cell(workload, seed, seconds, trace, device='cuda', bench=None, t_start=None,
             spec=None):
    """One run; returns (result dict, check lines).  ``spec`` replaces the
    cell's files (the tests' small sizes)."""
    import torch

    from . import check

    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or load_json(ROOT / 'BENCHMARK.json')
    cell, cfg, traffic, limits = spec or cell_spec(workload, bench)
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run = Run(cfg, traffic, seed, device, spans=bool(trace))
    with run.patched():
        run.setup()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log(f'set-up {setup_s:.1f} s')
        ctx = measure(run, seconds, trace, cfg, traffic)
        log(f"window {ctx['window_s']:.1f} s, {len(ctx['step_s'])} steps")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    data, prog = run.check_data()
    attempted, failed = len(ctx['step_s']), run.failed
    run.close()
    t_ref = time.perf_counter()
    truth = check.reference_side(data, cfg, traffic, device)
    numbers = check.compare(prog, truth, data['P0'])
    log(f'reference {time.perf_counter() - t_ref:.1f} s')
    checks = {k: {'value': numbers[k], 'limit': v} for k, v in limits.items()}
    correct = failed == 0 and all(c['value'] <= c['limit'] for c in checks.values())
    ctx |= {'setup_s': setup_s, 'peak_bytes': peak, 'walkers': traffic['walkers']}
    entries = bench['per_layer'] if trace else bench['end_to_end']
    metrics = _metrics(entries, workload, ctx)
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(run.device) if cuda else 'cpu',
           'count': 1, 'memory_peak_bytes': peak}
    result = {'correct': correct, 'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': dev}
    if trace:
        dev |= {'busy_s': ctx['profile']['busy_s'], 'window_s': ctx['profile']['window_s']}
        result['breakdown'] = ctx['profile']['breakdown']
    result['checks'] = checks
    lines = [f"{k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    lines.append(f'failed steps {failed} limit 0')
    return result, lines


def set_cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own nvcc build directory is ``deepqmc_tpu_torch/_build/``)."""
    cache = ROOT / '.qmcbench_cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')


def main(args, t_start):
    set_cache_dirs()
    bench = load_json(ROOT / 'BENCHMARK.json')
    cell = cell_spec(args.workload, bench)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        print(f"qmcbench: the cell needs {cell['chips']} CUDA device(s); "
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} found',
              file=sys.stderr)
        return 1
    if not (ROOT / 'deepqmc_tpu_torch').is_dir():
        print('qmcbench: the port deepqmc_tpu_torch is not in this checkout', file=sys.stderr)
        return 1
    result, lines = run_cell(args.workload, args.seed, args.seconds, args.trace, 'cuda', bench,
                             t_start)
    found = forbidden_modules()
    if found:
        print(f'qmcbench: the process loaded {found}', file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0
