"""The port's spans and counters (``deepqmc_tpu_torch.tracing``) on the CPU:
free and silent while off; while on, the span tree of the fit loop's steps
(a small PsiFormer trained by KFAC, and an evaluation step) with parents,
step ids and counts; the same numbers with tracing on and off; the host
clock that of ``torch.profiler``'s events; the sync counter; the summary."""

import copy
import itertools
import warnings

import pytest
import torch

import deepqmc_tpu_torch as dqt
from deepqmc_tpu_torch import fit, tracing
from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
from deepqmc_tpu_torch.observable import ElectronPositionMonitor
from deepqmc_tpu_torch.optimizer import KFACOptimizer, NoOptimizer
from deepqmc_tpu_torch.sampling import initialize_sampler_state, initialize_sampling

WALKERS, MOVES, PERIOD = 8, 2, 2
TRAIN_STEP = ['step', 'sampling.sample', *['sampling.move'] * MOVES, 'local_energy', 'grad',
              'grad.backward', 'grad.taps', 'kfac.update', 'kfac.factors', 'kfac.inverses',
              'kfac.precondition', 'sampling.update', 'fit.stats', 'fit.host_read',
              'fit.monitors']
EVAL_STEP = ['step', 'sampling.sample', *['sampling.move'] * MOVES, 'local_energy', 'fit.stats',
             'fit.host_read', 'fit.monitors']
PARENTS = {'sampling.sample': 'step', 'sampling.move': 'sampling.sample', 'local_energy': 'step',
           'grad': 'step', 'grad.backward': 'grad', 'grad.taps': 'grad',
           'kfac.update': 'step', 'kfac.factors': 'kfac.update',
           'kfac.inverses': 'kfac.update', 'kfac.precondition': 'kfac.update',
           'sampling.update': 'step', 'fit.stats': 'step', 'step': None,
           'fit.host_read': None, 'fit.monitors': None}


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope='module')
def model():
    torch.manual_seed(0)
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2O'))
    wf = dqt.psiformer_ansatz(hamil, n_determinants=2, embedding_dim=32, n_interactions=4,
                              num_heads=2)
    return hamil, wf


def fit_loop(model, training=True):
    """A fresh ``fit_wf`` generator of the small PsiFormer on the CPU, the
    same walkers, weights and draws each time."""
    hamil, wf = model[0], copy.deepcopy(model[1])
    idx, sampler = initialize_sampling(torch.Generator().manual_seed(2), hamil, wf, [hamil.mol],
                                       1, 1, elec_sampler=fit.electron_sampler(None, MOVES))
    grad_mode = fit.sampling_grad_mode(sampler, inference=not training)
    with grad_mode():
        state = initialize_sampler_state(torch.Generator().manual_seed(0), sampler, WALKERS,
                                         [hamil.mol], dtype=torch.float32)
    if training:
        def optimizer(loss):
            return KFACOptimizer(loss, **fit.DEFAULT_OPT_KWARGS['kfac'],
                                 inverse_update_period=PERIOD)
    else:
        optimizer = NoOptimizer
    return wf, fit.fit_wf(
        torch.Generator().manual_seed(1), hamil, wf, optimizer, idx, sampler, itertools.count(),
        fit.TrainState(state, None, None),
        lambda h, w: create_loss_fn(h, w, median_log_squeeze_and_mask),
        [ElectronPositionMonitor(save_samples=True, period=1).finalize(hamil, wf)],
        block_size=1, grad_mode=grad_mode)


def by_step(recs):
    steps: dict = {}
    for i, r in enumerate(recs):
        steps.setdefault(r['step'], []).append((i, r))
    return steps


def test_off_is_one_shared_no_op_and_records_nothing(model):
    assert tracing.span('a') is tracing.span('b', walkers=3) is tracing.step(7) is tracing.NULL
    with tracing.span('a') as s:
        pass
    assert s is tracing.NULL
    _, run = fit_loop(model)
    for _ in range(2):
        next(run)
    assert tracing.records() == []


def test_training_steps_give_the_span_tree(model):
    tracing.enable()
    _, run = fit_loop(model)
    for _ in range(3):
        next(run)
    tracing.disable()
    recs = tracing.records()
    steps = by_step(recs)
    assert sorted(steps) == [0, 1, 2]
    for n, entries in steps.items():
        refresh = n % PERIOD == 0
        want = [x for x in TRAIN_STEP if refresh or x != 'kfac.inverses']
        assert [r['name'] for _, r in entries] == want
        for _, r in entries:
            parent = r['parent']
            assert (recs[parent]['name'] if parent is not None else None) == PARENTS[r['name']]
            if parent is not None:
                assert recs[parent]['step'] == n
                assert recs[parent]['start_ns'] <= r['start_ns'] <= r['end_ns'] \
                    <= recs[parent]['end_ns']
            assert r['counts']['syncs'] == 0  # no device on the CPU
        for _, r in entries:  # moves is the only count besides syncs
            want_counts = {'syncs': 0}
            if r['name'] == 'sampling.sample':
                want_counts['moves'] = MOVES
            assert r['counts'] == want_counts
        step = entries[0][1]
        assert set(step['launches']) == set(dqt.ops.launch_counts())
        assert not any(step['launches'].values())  # the wrappers count on the card only


def test_tracing_changes_no_number(model):
    out = {}
    for on in (False, True):
        if on:
            tracing.enable()
        wf, run = fit_loop(model)
        samples = [next(run)[4] for _ in range(2)]
        _, state, *_ = next(run)
        tracing.disable()
        out[on] = ({k: v.clone() for k, v in wf.state_dict().items()},
                   state.sampler['elec']['r'].clone(),
                   [s['local_energy/samples'] for s in samples])
    (p0, r0, e0), (p1, r1, e1) = out[False], out[True]
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert torch.equal(r0, r1)
    assert all((a == b).all() for a, b in zip(e0, e1))
    assert tracing.records()  # the second run recorded


def test_evaluation_step_has_no_gradient_or_kfac_spans(model):
    tracing.enable()
    _, run = fit_loop(model, training=False)
    next(run)
    tracing.disable()
    assert [r['name'] for r in tracing.records()] == EVAL_STEP


def test_spans_lie_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span('work'):
            x @ x
    tracing.disable()
    (rec,) = tracing.records()
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == 'aten::mm']
    assert ops
    for e in ops:
        assert rec['start_ns'] <= e.start_ns() <= e.start_ns() + e.duration_ns() <= rec['end_ns']


def test_sync_warnings_count_in_the_innermost_span_unshown():
    def sync():
        warnings.warn(f'{tracing.SYNC_WARNING} (Triggered internally)', UserWarning)

    tracing.enable()
    with tracing.span('outer'):
        sync()
        with tracing.span('inner'):
            for _ in range(3):
                sync()
        with tracing.span('quiet'):
            pass
    with pytest.warns(UserWarning, match='another warning'):
        warnings.warn('another warning', UserWarning)
    sync()  # outside every span: counted nowhere
    tracing.disable()
    assert [(r['name'], r['counts']['syncs']) for r in tracing.records()] == [
        ('outer', 1), ('inner', 3), ('quiet', 0)]
    with pytest.warns(UserWarning, match=tracing.SYNC_WARNING):
        sync()  # shown again once tracing is off


def test_span_counts_nest_and_reset_drops_all():
    tracing.enable()
    with tracing.span('a', moves=3):
        with tracing.span('b'):
            pass
        with tracing.span('c', moves=2):
            pass
    tracing.enable()  # again: still on, records kept
    recs = tracing.records()
    assert [(r['name'], r['parent'], r['counts']) for r in recs] == [
        ('a', None, {'moves': 3, 'syncs': 0}), ('b', 0, {'syncs': 0}),
        ('c', 0, {'moves': 2, 'syncs': 0})]
    tracing.reset()
    assert tracing.records() == []


def test_summary_gives_calls_times_syncs_and_launches(monkeypatch):
    from deepqmc_tpu_torch import ops

    launched = dict.fromkeys(ops.launch_counts(), 0)
    monkeypatch.setattr(ops, 'launch_counts', lambda: dict(launched))
    tracing.enable()
    for n in range(2):
        with tracing.step(n):
            for _ in range(3):
                with tracing.span('sampling.move'):
                    launched['fl_attention'] += 4
            with tracing.span('local_energy'):
                launched['fl_slogdet_traces'] += 1
        with tracing.span('fit.host_read'):
            pass
    tracing.disable()
    stats = tracing.span_stats()
    assert stats['steps'] == 2
    assert {k: s['calls'] for k, s in stats['spans'].items()} == {
        'step': 1, 'sampling.move': 3, 'local_energy': 1, 'fit.host_read': 1}
    assert stats['launches']['fl_attention'] == 12 and stats['launches']['fl_slogdet_traces'] == 1
    step = stats['spans']['step']
    assert step['self_ms'] <= step['host_ms']
    text = tracing.summary()
    assert text.splitlines()[0] == '2 steps; per step:'
    assert '  sampling.move' in text and 'fl_attention 12' in text
