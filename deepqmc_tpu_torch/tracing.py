"""Spans and counters inside the port's fit step, off by default.

    from deepqmc_tpu_torch import tracing

    tracing.enable()
    ...                       # fit or evaluation steps
    tracing.disable()
    print(tracing.summary())  # per span: calls, host ms, syncs a step; launches a step
    tracing.records()         # one dict per span, in the order they opened

A span is ``with tracing.span(name, **counts):`` around a piece of a step;
the fit loop opens ``tracing.step(n)`` around step ``n``, and every span
until the next step carries ``n`` as its ``step``.  The part of a name
before its first dot is the span's layer (``sampling``, ``local_energy``,
``grad``, ``kfac``; ``step`` and ``fit.*`` are the layer ``fit``); a layer is
charged with the time where one of its spans is the innermost open one.

With tracing off, :func:`span` and :func:`step` check one module flag and
return one shared no-op context manager: no clock read, no CUDA event, no
allocation.  With tracing on, each span appends one record to a list in
memory: its name, the index of the enclosing open span (``parent``), the step,
host ``start_ns`` and ``end_ns``, and its counts (the integers passed in, and
``syncs``).  A ``step`` span also keeps the
step's launches of each hand-written kernel (deltas of
:func:`.ops.launch_counts`).

Host times are ``time.time_ns()``, Unix time, the clock ``torch.profiler``
gives its events (``_KinetoEvent.start_ns()``), so a record lies over the
profiler's device trace with no offset.

``syncs`` counts the blocking device-to-host waits inside a span and none of
its children (``.item()``, copies to the host, ``nonzero``, linear-algebra
error checks): while tracing is on, CUDA's sync debug mode is 'warn', and
each of its warnings adds one to the innermost open span instead of being
printed.  On the CPU it reads 0.
"""

import time
import warnings

__all__ = ['disable', 'enable', 'records', 'reset', 'span', 'span_stats',
           'step', 'summary']

SYNC_WARNING = 'called a synchronizing CUDA operation'

_on = False
_records: list = []  # [name, parent, step, start_ns, end_ns, counts, launches]
_open: list = []  # indices into _records of the open spans, innermost last
_step = None
_restore = None  # what enable() changed, put back by disable()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Span:
    __slots__ = ('rec', 'index', 'launches')

    def __init__(self, name, counts, launches=None):
        counts['syncs'] = 0
        self.rec = [name, None, _step, 0, 0, counts, None]
        self.launches = launches

    def __enter__(self):
        rec = self.rec
        rec[1] = _open[-1] if _open else None
        self.index = len(_records)
        _open.append(self.index)
        _records.append(rec)
        if self.launches is not None:
            self.launches = self.launches()
        rec[3] = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[4] = time.time_ns()
        if self.launches is not None:
            now = _launch_counts()
            rec[6] = {k: now[k] - self.launches[k] for k in now}
        if _open and _open[-1] == self.index:
            _open.pop()
        return False


def _launch_counts():
    from .ops import launch_counts

    return launch_counts()


def span(name: str, **counts):
    """A span ``name`` with the integer ``counts`` (a no-op while tracing is off)."""
    if not _on:
        return NULL
    return _Span(name, counts)


def step(n):
    """The span ``step`` around fit step ``n``; spans from here to the next
    step carry ``n``."""
    global _step
    if not _on:
        return NULL
    _step = n
    return _Span('step', {}, _launch_counts)


def _show(message, category, filename, lineno, file=None, line=None):
    if SYNC_WARNING in str(message):
        if _open:
            _records[_open[-1]][5]['syncs'] += 1
        return
    _restore[1](message, category, filename, lineno, file, line)


def enable():
    """Record spans from now on, and count the blocking device-to-host waits
    where CUDA is present."""
    global _on, _restore
    if _on:
        disable()
    import torch

    catcher = warnings.catch_warnings()
    catcher.__enter__()
    warnings.filterwarnings('always', message=SYNC_WARNING)
    warnings.filterwarnings('ignore', message='Synchronization debug mode is a prototype')
    mode = None
    if torch.cuda.is_available():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode('warn')
    _restore = (catcher, warnings.showwarning, mode)
    warnings.showwarning = _show
    _on = True


def disable():
    """Stop recording; the records stay until :func:`reset`."""
    global _on, _restore
    _on = False
    if _restore is not None:
        catcher, _, mode = _restore
        if mode is not None:
            import torch

            torch.cuda.set_sync_debug_mode(mode)
        catcher.__exit__(None, None, None)
        _restore = None


def reset():
    """Drop the records (spans still open record nothing more)."""
    global _step
    _records.clear()
    _open.clear()
    _step = None


def records() -> list[dict]:
    """The spans recorded, in the order they opened; ``launches`` on ``step`` spans."""
    out = []
    for name, parent, step_, start, end, counts, launches in _records:
        rec = {'name': name, 'parent': parent, 'step': step_, 'start_ns': start, 'end_ns': end,
               'counts': dict(counts)}
        if launches is not None:
            rec['launches'] = dict(launches)
        out.append(rec)
    return out


def span_stats(recs=None, steps=None) -> dict:
    """Per span name, a step's mean ``calls``, ``host_ms`` (the spans'
    durations), ``self_ms`` (less their children's) and ``syncs``, over the
    steps recorded (those of ``steps`` where given); ``launches`` the
    kernels' launches a step."""
    recs = records() if recs is None else recs
    child_ns = [0] * len(recs)
    for r in recs:
        if r['parent'] is not None and r['end_ns']:
            child_ns[r['parent']] += r['end_ns'] - r['start_ns']
    done = [(i, r) for i, r in enumerate(recs)
            if r['end_ns'] and (steps is None or r['step'] in steps)]
    if steps is None:
        steps = {r['step'] for _, r in done if r['name'] == 'step'} or {r['step'] for _, r in done}
    n = max(len(steps), 1)
    spans: dict = {}
    for i, r in done:
        s = spans.setdefault(r['name'], {'calls': 0, 'host_ms': 0.0, 'self_ms': 0.0, 'syncs': 0})
        ns = r['end_ns'] - r['start_ns']
        s['calls'] += 1
        s['host_ms'] += 1e-6 * ns
        s['self_ms'] += 1e-6 * (ns - child_ns[i])
        s['syncs'] += r['counts']['syncs']
    launches: dict = {}
    for _, r in done:
        for k, v in r.get('launches', {}).items():
            launches[k] = launches.get(k, 0) + v
    return {'steps': len(steps),
            'spans': {k: {q: v / n for q, v in s.items()} for k, s in spans.items()},
            'launches': {k: v / n for k, v in launches.items()}}


def summary(recs=None, steps=None) -> str:
    """:func:`span_stats` as a table, a span's children indented below it."""
    recs = records() if recs is None else recs
    stats = span_stats(recs, steps)
    children: dict = {}  # a name's child names, by the parent of its first span
    for name in stats['spans']:
        first = next(r for r in recs if r['name'] == name)
        parent = None if first['parent'] is None else recs[first['parent']]['name']
        children.setdefault(parent, []).append(name)
    lines = [f"{stats['steps']} steps; per step:",
             f"{'span':<28}{'calls':>8}{'host ms':>11}{'self ms':>11}{'syncs':>8}"]
    todo = [(name, 0) for name in reversed(children.get(None, []))]
    while todo:
        name, depth = todo.pop()
        todo += [(c, depth + 1) for c in reversed(children.get(name, []))]
        s, label = stats['spans'][name], '  ' * depth + name
        lines.append(f"{label:<28}{s['calls']:>8.2f}{s['host_ms']:>11.3f}{s['self_ms']:>11.3f}"
                     f"{s['syncs']:>8.2f}")
    launches = ', '.join(f'{k} {v:g}' for k, v in stats['launches'].items())
    lines.append(f'kernel launches: {launches or "none recorded"}')
    return '\n'.join(lines)
