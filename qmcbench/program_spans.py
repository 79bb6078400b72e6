"""The program's own spans read against the device's trace.

The port records spans inside its fit step (``deepqmc_tpu_torch.tracing``):
a name, the enclosing span, the step, host ``start_ns`` and ``end_ns`` on
the clock of ``torch.profiler``'s events, and counts.  The readers of
``metrics/`` take them from ``ctx['program']``:

- ``records``: ``tracing.records()`` of the run, in the order they opened
  (``parent`` indexes this list);
- ``traced_steps`` and ``window_steps``: the step ids of the profiled steps
  and of every step of the window (the profiled ones included);
- ``window_ns``: the profiled steps' window, on the same clock;
- ``device``: each device operation of that window as ``(start_ns, end_ns,
  name, correlation id)``, None where nothing ran on a device;
- ``launch_ns``: the host time of each operation's launch by correlation id,
  where the trace carries the runtime's launch events (else empty).

The spans and the runtime's launch calls are on one host clock, Unix time
in ns; the device's intervals come converted from the card's timer, and on
an H100 some traces put kernels before their own launch calls, by a lag
that may grow through the trace (to 0.56 ms in 1.1 s).  :func:`skew_line`
is the lowest line over the device's time that lies above every
operation's lead over its launch (launch call start minus device start),
taken at the middle of the trace: the smallest steady drift that lets no
operation start before it was launched.  :func:`aligned` moves the device's
times later by it where it is positive.  The device is idle where no
operation's interval lies within the window; each idle stretch is charged,
by exact intersection, to the layer of the innermost span open on the host
then (the part of its name before the first dot; ``step`` and ``fit.*`` are
the layer ``fit``), and what lies inside no span is unattributed.  Programs
without the spans give readers nothing.
"""

from bisect import bisect_right
from collections import defaultdict

import torch

__all__ = ['LAYERS', 'aligned', 'device_ops', 'idle_by_layer', 'idle_gaps', 'innermost',
           'launches_per_move', 'layer_idle_ms', 'layer_of', 'refresh_ms', 'skew_line',
           'syncs_per_step', 'unattributed_share']

LAYERS = ('sampling', 'local_energy', 'grad', 'kfac', 'fit')


def layer_of(name):
    head = name.split('.')[0]
    return 'fit' if head == 'step' else head


def device_ops(prof):
    """(the device operations ``[(start_ns, end_ns, name, correlation)]`` in
    time order, the runtime's launch calls ``{correlation: (start_ns,
    end_ns)}`` on the host) of a finished profile."""
    ops, calls = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                ops.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(),
                            ev.correlation_id()))
        elif ev.name().startswith('cu') and ev.correlation_id():
            calls.setdefault(ev.correlation_id(), (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return sorted(ops), calls


def skew_line(ops, launch_ns):
    """``(t0, lead0, slope)``: the device's lag behind the host at device
    time ``t`` is at least ``lead0 + slope * (t - t0)``, the edge of the upper
    hull of the points (device start, launch call start - device start) over
    the middle of their span (None without linked launches)."""
    lead = {}
    for s, _, _, c in ops:
        if c in launch_ns:
            lead[s] = max(lead.get(s, launch_ns[c] - s), launch_ns[c] - s)
    hull = []
    for p in sorted(lead.items()):
        while len(hull) > 1 and ((hull[-1][0] - hull[-2][0]) * (p[1] - hull[-2][1])
                                 >= (hull[-1][1] - hull[-2][1]) * (p[0] - hull[-2][0])):
            hull.pop()
        hull.append(p)
    if not hull:
        return None
    mid = (hull[0][0] + hull[-1][0]) / 2
    for (x0, y0), (x1, y1) in zip(hull, hull[1:]):
        if x0 <= mid <= x1:
            return x0, y0, (y1 - y0) / (x1 - x0)
    return hull[0][0], hull[0][1], 0.0


def aligned(prog):
    """The device operations of ``prog`` on the host's clock: each time
    moved later by the lag :func:`skew_line` gives there, where positive."""
    line = skew_line(prog['device'], prog['launch_ns'])
    if line is None:
        return list(prog['device'])
    t0, lead0, slope = line

    def host(t):
        return t + max(0, round(lead0 + slope * (t - t0)))

    return [(host(s), host(e), name, c) for s, e, name, c in prog['device']]


def idle_gaps(ops, w0, w1):
    """The stretches of ``[w0, w1]`` that no operation's interval covers."""
    gaps, cur = [], w0
    for s, e, *_ in sorted(ops):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    return gaps


def innermost(records):
    """``[(start, end, layer)]``: the host's timeline where each span is the
    innermost open one, time-ordered (spans of one thread nest, so the pieces
    do not overlap)."""
    children = defaultdict(list)
    for i, r in enumerate(records):
        if r['parent'] is not None and r['end_ns']:
            children[r['parent']].append(i)
    pieces = []
    for i, r in enumerate(records):
        if not r['end_ns']:
            continue
        cur, layer = r['start_ns'], layer_of(r['name'])
        for c in children[i]:  # opened in order, so sorted by start
            if records[c]['start_ns'] > cur:
                pieces.append((cur, records[c]['start_ns'], layer))
            cur = max(cur, records[c]['end_ns'])
        if r['end_ns'] > cur:
            pieces.append((cur, r['end_ns'], layer))
    return sorted(pieces)


def idle_by_layer(records, ops, w0, w1):
    """(the idle ns of the window, ``{layer: idle ns}`` inside the layer's
    spans); the rest of the idle time is inside no span."""
    gaps = idle_gaps(ops, w0, w1)
    charged = dict.fromkeys(LAYERS, 0)
    pieces, j = innermost(records), 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, layer = pieces[k]
            charged[layer] = charged.get(layer, 0) + min(b, e) - max(a, s)
            k += 1
    return sum(b - a for a, b in gaps), charged


def program(ctx):
    return ctx.get('program') or None


def layer_idle_ms(ctx, layer):
    """A layer's idle ms a profiled step (None without the spans or a device trace)."""
    prog = program(ctx)
    if not prog or not prog['device'] or not prog['traced_steps']:
        return None
    _, charged = idle_by_layer(prog['records'], aligned(prog), *prog['window_ns'])
    return 1e-6 * charged[layer] / len(prog['traced_steps'])


def unattributed_share(ctx):
    """The window's idle time inside no span, in % of its idle time."""
    prog = program(ctx)
    if not prog or not prog['device']:
        return None
    total, charged = idle_by_layer(prog['records'], aligned(prog), *prog['window_ns'])
    return 100 * (total - sum(charged.values())) / total if total else None


def _window_records(prog, steps_key):
    steps = set(prog[steps_key])
    return [r for r in prog['records'] if r['step'] in steps and r['end_ns']]


def refresh_ms(ctx):
    """The mean host ms of the window's KFAC inverse refreshes."""
    prog = program(ctx)
    if not prog:
        return None
    times = [r['end_ns'] - r['start_ns'] for r in _window_records(prog, 'window_steps')
             if r['name'] == 'kfac.inverses']
    return 1e-6 * sum(times) / len(times) if times else None


def syncs_per_step(ctx):
    """The blocking device-to-host waits a window step, over every span."""
    prog = program(ctx)
    if not prog or not prog['window_steps']:
        return None
    recs = _window_records(prog, 'window_steps')
    if not recs:
        return None
    return sum(r['counts'].get('syncs', 0) for r in recs) / len(prog['window_steps'])


def launches_per_move(ctx):
    """Device operations launched inside a ``sampling.move`` span of the
    profiled steps, over the moves counted there (None where the trace has
    no launch events)."""
    prog = program(ctx)
    if not prog or not prog['device'] or not prog['launch_ns']:
        return None
    recs = _window_records(prog, 'traced_steps')
    moves = sum(r['counts'].get('moves', 0) for r in recs if r['name'] == 'sampling.sample')
    spans = sorted((r['start_ns'], r['end_ns']) for r in recs if r['name'] == 'sampling.move')
    if not moves or not spans:
        return None
    starts = [s for s, _ in spans]
    inside = 0
    for *_, corr in prog['device']:
        t = prog['launch_ns'].get(corr)
        if t is None:
            continue
        i = bisect_right(starts, t) - 1
        inside += i >= 0 and t <= spans[i][1]
    return inside / moves
