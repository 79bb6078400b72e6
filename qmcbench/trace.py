"""Spans at the port's layer boundaries and the reading of a profiler trace.

The spans wrap public functions of the port from outside (no program file
changes): each call runs inside ``torch.profiler.record_function`` with a
CUDA event before and after it, so its time on the device's timeline is
read once the window has closed.  On the CPU (the tests) the host clock
stands in for the events.

The trace is read from the profiler's own events, recorded on the device
alone (the host's operations are not recorded: that would slow the host
threefold and inflate the idle share it measures): the device is busy where
the union of its kernels', copies' and sets' intervals lies, and each idle
gap between them is named after the span the host was in then, by the
spans' own host clock (nanoseconds since the epoch, the profiler's clock).
"""

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ['Spans', 'kernel_roofline', 'read_profile', 'span_ms', 'union_s']

PREFIX = 'qmcbench.'


class _HostEvent:
    """A CUDA event's stand-in on the CPU: the host clock when recorded."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


class Spans:
    """Spans by name and step; ``step`` is set by the caller before each step
    (spans outside a step, ``step`` None, are not kept)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'
        self.step = None
        self.records = []  # (step, name, start, end)
        self.calls = defaultdict(list)  # name -> [(step, size)]
        self.host = []  # (start ns, end ns, name) on the host's clock

    def _event(self):
        return torch.cuda.Event(enable_timing=True) if self.cuda else _HostEvent()

    @contextlib.contextmanager
    def span(self, name, size=None):
        if self.step is None:
            yield
            return
        start, end = self._event(), self._event()
        t0 = time.time_ns()
        with torch.profiler.record_function(PREFIX + name):
            start.record()
            yield
            end.record()
        self.host.append((t0, time.time_ns(), name))
        self.records.append((self.step, name, start, end))
        self.calls[name].append((self.step, size))

    def wrap(self, name, fn, size_of=None):
        def wrapped(*args, **kwargs):
            with self.span(name, size_of(*args, **kwargs) if size_of else None):
                return fn(*args, **kwargs)

        return wrapped

    def per_step_ms(self):
        """{step: {name: ms}}, summed over the calls of a step."""
        if self.cuda:
            torch.cuda.synchronize()
        out = defaultdict(lambda: defaultdict(float))
        for step, name, start, end in self.records:
            out[step][name] += start.elapsed_time(end)
        return out


def union_s(intervals):
    """The length of the union of ``(start, end)`` intervals, and its gaps."""
    total, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
                gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def _host_label(t, spans):
    """The innermost span the host was in at ``t`` (ns)."""
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else 'fit loop, outside the layer spans'


def read_profile(prof, window_s, host_spans, top=10):
    """From a finished ``torch.profiler.profile``: the device's busy seconds
    over ``window_s``, the device time by operation name, the idle gaps
    longest first with the host's span, and each kernel's intervals."""
    device = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation():
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
    busy, gaps = union_s([(s, e) for s, e, _ in device])
    by_name = defaultdict(float)
    kernels = defaultdict(list)
    for s, e, name in device:
        by_name[name] += 1e-9 * (e - s)
        kernels[name].append(1e-9 * (e - s))
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = [[_host_label((a + b) // 2, host_spans), 1e-9 * (b - a)] for a, b in longest]
    return {
        'busy_s': 1e-9 * busy, 'window_s': window_s, 'kernels': dict(kernels),
        'breakdown': {'device_ops': [[name[:160], t] for name, t in device_ops],
                      'idle_gaps': idle},
    }


def span_ms(ctx, name):
    """A layer's span time per step, over the window's steps (None without spans)."""
    steps = ctx['steps']
    if not steps or not any(name in s['spans'] for s in steps):
        return None
    return sum(s['spans'].get(name, 0.0) for s in steps) / len(steps)


def kernel_roofline(ctx, marker, bound_of):
    """A kernel's share of its roofline in %: the bound of the local energies
    traced (``bound_of(B)`` seconds for one of ``B`` walkers) over the device
    time of the kernels whose name holds ``marker``."""
    prof = ctx['profile']
    if not prof:
        return None
    spent = sum(sum(ts) for name, ts in prof['kernels'].items() if marker in name)
    if not spent or not prof['eloc_walkers']:
        return None
    return 100 * sum(bound_of(B) for B in prof['eloc_walkers']) / spent
