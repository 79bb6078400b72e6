"""The program-span readers on synthetic spans and device intervals, and
``qmcbench/program_trace.py`` at a tiny width on the CPU."""

import pytest

from qmcbench import harness, program_spans
from qmcbench.tests.conftest import tiny_spec


def rec(name, parent, step, start, end, **counts):
    return {'name': name, 'parent': parent, 'step': step, 'start_ns': start, 'end_ns': end,
            'counts': {'syncs': 0, **counts}}


# one step: sampling (two moves), the local energy, KFAC with a refresh; then
# the host read outside the step and a stretch (190-200) inside no span
RECORDS = [
    rec('step', None, 0, 0, 150),                                   # 0
    rec('sampling.sample', 0, 0, 10, 50, moves=2),                  # 1
    rec('sampling.move', 1, 0, 12, 25, syncs=1),                    # 2
    rec('sampling.move', 1, 0, 30, 48),                             # 3
    rec('local_energy', 0, 0, 55, 90),                              # 4
    rec('kfac.update', 0, 0, 100, 140),                             # 5
    rec('kfac.inverses', 5, 0, 105, 135, syncs=2),                  # 6
    rec('fit.host_read', None, 0, 150, 190, syncs=1),               # 7
]
# device operations (start, end, name, correlation id) over the window 0-200
OPS = [(0, 14, 'k', 1), (20, 40, 'k', 2), (35, 60, 'k', 3), (70, 110, 'k', 4),
       (120, 130, 'k', 5), (160, 170, 'k', 6)]
LAUNCH_NS = {1: -1, 2: 18, 3: 33, 4: 52, 5: 115, 6: 151}  # none after its start


def ctx(records=RECORDS, ops=OPS, launch_ns=LAUNCH_NS, window=(0, 200)):
    return {'program': {'records': records, 'traced_steps': [0], 'window_steps': [0],
                        'window_ns': list(window), 'device': ops, 'launch_ns': launch_ns}}


def test_skew_line_is_the_lowest_line_over_the_leads():
    # leads (launch - start): 4 at 10 and 1 at 50 bound it; -5 at 30 is a queued launch
    ops = [(10, 20, 'k', 1), (30, 40, 'k', 2), (50, 60, 'k', 3)]
    assert program_spans.skew_line(ops, {1: 14, 2: 25, 3: 51}) == (10, 4, -3 / 40)
    assert program_spans.skew_line(ops, {1: 14}) == (10, 4, 0.0)
    assert program_spans.skew_line(ops, {}) is None
    # a lag growing 1 ns every 10 ns, with queued launches below it
    ops = [(t, t + 5, 'k', t) for t in range(0, 1001, 50)]
    launch_ns = {t: t + t // 10 - (7 if t % 100 else 0) for t in range(0, 1001, 50)}
    t0, lead0, slope = program_spans.skew_line(ops, launch_ns)
    assert [lead0 + slope * (t - t0) for t in (0, 500, 1000)] == pytest.approx([0, 50, 100])


def test_device_intervals_move_later_by_the_lag_where_positive():
    ops = [(10, 20, 'k', 1), (30, 40, 'k', 2), (50, 60, 'k', 3)]
    prog = {'device': ops, 'launch_ns': {1: 14, 3: 54}}  # a steady lag of 4
    assert program_spans.aligned(prog) == [(14, 24, 'k', 1), (34, 44, 'k', 2), (54, 64, 'k', 3)]
    late = {'device': ops, 'launch_ns': {1: 8, 3: 49}}  # each launched before its start
    assert program_spans.aligned(late) == ops
    # shifted, the gap 20-30 moves to 24-34: into local_energy's span 33-40
    records = [rec('sampling.move', None, 0, 0, 33), rec('local_energy', None, 0, 33, 40)]
    c = ctx(records=records, ops=ops, launch_ns=prog['launch_ns'], window=(14, 44))
    assert program_spans.layer_idle_ms(c, 'local_energy') == pytest.approx(1e-6)
    assert program_spans.layer_idle_ms(c, 'sampling') == pytest.approx(9e-6)


def test_idle_gaps_cover_the_window_outside_the_operations():
    assert program_spans.idle_gaps(OPS, 0, 200) == [
        (14, 20), (60, 70), (110, 120), (130, 160), (170, 200)]
    assert program_spans.idle_gaps(OPS, 5, 165) == [
        (14, 20), (60, 70), (110, 120), (130, 160)]
    assert program_spans.idle_gaps([], 3, 9) == [(3, 9)]


def test_innermost_pieces_partition_the_spans():
    pieces = program_spans.innermost(RECORDS)
    assert pieces == [
        (0, 10, 'fit'), (10, 12, 'sampling'), (12, 25, 'sampling'), (25, 30, 'sampling'),
        (30, 48, 'sampling'), (48, 50, 'sampling'), (50, 55, 'fit'), (55, 90, 'local_energy'),
        (90, 100, 'fit'), (100, 105, 'kfac'), (105, 135, 'kfac'), (135, 140, 'kfac'),
        (140, 150, 'fit'), (150, 190, 'fit')]


def test_a_known_gap_in_a_known_span_is_charged_to_its_layer():
    ops = [(0, 100, 'k', 1), (107, 200, 'k', 2)]  # idle 100-107, inside kfac.inverses
    total, charged = program_spans.idle_by_layer(RECORDS, ops, 0, 200)
    assert total == 7 and charged == {'sampling': 0, 'local_energy': 0, 'grad': 0,
                                      'kfac': 7, 'fit': 0}


def test_partial_overlaps_split_exactly():
    total, charged = program_spans.idle_by_layer(RECORDS, OPS, 0, 200)
    # 14-20 sampling; 60-70 local energy; 110-120 kfac; 130-160: kfac 130-140,
    # step 140-150, host read 150-160; 170-200: host read 170-190, none 190-200
    assert charged == {'sampling': 6, 'local_energy': 10, 'grad': 0, 'kfac': 20, 'fit': 40}
    assert total == 86
    c = ctx()
    layers = {k: program_spans.layer_idle_ms(c, k) for k in program_spans.LAYERS}
    assert layers['kfac'] == pytest.approx(20e-6)
    assert program_spans.unattributed_share(c) == pytest.approx(100 * 10 / 86)


@pytest.mark.parametrize('window', [(0, 200), (5, 165), (12, 199)])
def test_layers_and_unattributed_give_back_the_idle_time(window):
    c = ctx(window=window)
    total, _ = program_spans.idle_by_layer(RECORDS, OPS, *window)
    w0, w1 = window
    busy = sum(e - s for s, e in [(max(a, w0), min(b, w1)) for a, b, *_ in OPS]
               if e > s) - (40 - 35)  # the two overlapping operations counted once
    assert total == (w1 - w0) - busy
    layers = sum(1e6 * program_spans.layer_idle_ms(c, k) for k in program_spans.LAYERS)
    unattributed = total * program_spans.unattributed_share(c) / 100
    assert layers + unattributed == pytest.approx(total)


def test_host_span_readers():
    c = ctx()
    assert program_spans.refresh_ms(c) == pytest.approx(30e-6)
    assert program_spans.syncs_per_step(c) == 4
    # launches inside a move: correlations 2 (t 18) and 3 (t 33)
    assert program_spans.launches_per_move(c) == 2 / 2


def test_readers_read_nothing_without_the_program_or_a_device():
    names = ['sampling_idle_ms', 'local_energy_idle_ms', 'grad_idle_ms', 'kfac_idle_ms',
             'fit_idle_ms', 'idle_unattributed', 'kfac_refresh_ms', 'host_syncs_per_step',
             'sampling_launches_per_move']
    for name in names:
        assert harness._reader(name)({'profile': None}) is None
    no_device = ctx(ops=None)
    for name in names[:6] + names[-1:]:
        assert harness._reader(name)(no_device) is None
    assert harness._reader('kfac_refresh_ms')(no_device) == pytest.approx(30e-6)
    assert harness._reader('sampling_launches_per_move')(ctx(launch_ns={})) is None


@pytest.mark.parametrize('workload', ['psiformer_h2o.train', 'psiformer_h2o.eval'])
def test_program_trace_on_the_cpu(workload):
    from qmcbench import program_trace

    spec = tiny_spec(workload, warmup_steps=5)  # the window starts on a KFAC refresh
    result = program_trace.run_cell(workload, 2**31 + 11, 0.5, device='cpu', spec=spec)
    suffix = workload.split('.')[1]
    names = set(result['metrics'])
    assert f'host_syncs_per_step.{suffix}' in names
    assert result['metrics'][f'host_syncs_per_step.{suffix}'] == 0
    assert ('kfac_refresh_ms.train' in names) == (suffix == 'train')
    assert not any('idle' in n or 'launches' in n for n in names)  # no device trace
    assert result['idle_share'] is None and 'summary' in result
