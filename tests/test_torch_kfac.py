"""The port's KFAC against the JAX package's at float64 on the small PsiFormer:
the dense layers it discovers (the attention's output product among them), the
factor sums from the loss's taps (against JAX's inside its first step), three steps with ``inverse_update_period=2``
(inverses refreshed at steps 0 and 2 and carried at step 1) with the norm
constraint binding and not, and one step from a JAX state converted mid-run.
Each step's walkers are the same on both sides."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import (
    SMALL,
    assert_close,
    jax_batch,
    jax_model,
    torch_model,
    torch_phys_conf,
    walkers,
)

from deepqmc_tpu.kfac import KFAC as JaxKFAC
from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import median_log_squeeze_and_mask as jax_clip
from deepqmc_tpu.utils import ConstantSchedule as JaxConstant
from deepqmc_tpu.utils import InverseSchedule as JaxInverse
import deepqmc_tpu_torch as dqt
from deepqmc_tpu_torch.convert import kfac_state_from_jax, state_dict_from_jax
from deepqmc_tpu_torch.kfac import KFAC
from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
from deepqmc_tpu_torch.fwdlap import FL
from deepqmc_tpu_torch.nn import instrumented, jax_param_paths
from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule

REL, REL_STEP = 1e-10, 1e-9
N_STEPS, PERIOD = 3, 2
# (molecule, walkers, initial learning rate, norm constraint): LiH with the
# trust region binding (bench.py's settings), open-shell Li on an odd batch
# with a small learning rate and the trust region slack
CASES = {'binding': ('LiH', 8, 0.05, 1e-3), 'slack': ('Li', 7, 1e-4, 100.0)}


def _kfac_kwargs(schedule, constant, lr, nc):
    return dict(learning_rate_schedule=schedule(lr, 10000),
                damping_schedule=constant(1e-3), norm_constraint=nc,
                inverse_update_period=PERIOD)


def _models(mol, B, lr=0.05, nc=1e-3, seed=0):
    hamil_j, ansatz, params = jax_model(mol, seed=seed)
    hamil_t, wf = torch_model(mol, params)
    rs = [walkers(hamil_j, 'init_sample', n=B, seed=seed + 10 * k) for k in range(N_STEPS)]
    loss_j = jax_create_loss_fn(hamil_j, ansatz, jax_clip)
    kfac_j = JaxKFAC(loss_j.value_and_grad, **_kfac_kwargs(JaxInverse, JaxConstant, lr, nc))
    kfac_j.bind_ansatz(ansatz)
    kfac_t = KFAC(create_loss_fn(hamil_t, wf, median_log_squeeze_and_mask),
                  **_kfac_kwargs(InverseSchedule, ConstantSchedule, lr, nc))
    batches = [jax_batch(hamil_j, r) for r in rs]
    pcs = [torch_phys_conf(hamil_t, r) for r in rs]
    return (kfac_j, params, batches), (kfac_t, wf, pcs)


@pytest.fixture(scope='module', params=list(CASES))
def runs(request):
    """N_STEPS KFAC steps of both packages from the same start; JAX's states
    and parameters before each step, and what each step gave on both sides."""
    (kfac_j, params, batches), (kfac_t, wf, pcs) = _models(*CASES[request.param])
    rng = jax.random.PRNGKey(0)
    state_j = kfac_j.init(rng, [params], batches[0])
    state_t = kfac_t.init(pcs[0])
    step_j = jax.jit(kfac_j.step)
    out = []
    for batch, pc in zip(batches, pcs):
        before = (params, state_j)
        (params,), state_j, (E_j, _, _), stats_j = step_j(rng, [params], state_j, batch)
        weight = torch.ones(len(pc.r), dtype=torch.float64)
        state_t, (E_t, _, _), stats_t = kfac_t.step(state_t, pc, weight)
        got = {k: v.detach().clone() for k, v in wf.state_dict().items()}
        out.append(dict(before=before, params_j=params, state_j=state_j, E_j=E_j,
                        stats_j=stats_j, params_t=got, state_t=state_t, E_t=E_t,
                        stats_t=stats_t))
    return request.param, kfac_j, kfac_t, wf, pcs, out


BACKFLOW_DOWN = 'neural_network_wave_function/omni_net/backflow_1/mlp/linear_0'


def _assert_layers(got, want, n_down):
    """Paths, widths, bias, calls and rows per walker, in JAX's order."""
    assert [tuple(m) for m in got] == [tuple(m) for m in want]
    paths = [m.path for m in got]
    assert any(p.endswith('node_attention_electron_update_feature/attention') for p in paths)
    assert (BACKFLOW_DOWN in paths) == (n_down > 0)


@pytest.mark.parametrize('mol', ['H2_triplet'])
def test_discovered_layers_match_jax(mol):
    """Triplet H2's down-spin backflow sees no rows: both sides leave it out
    (the closed- and open-shell cases are checked in the steps' test)."""
    (kfac_j, params, batches), (kfac_t, wf, pcs) = _models(mol, 3)
    single = jax.tree_util.tree_map(lambda x: x[0, 0, 0], batches[0][0])
    _assert_layers(kfac_t._discover_layers(pcs[0]), kfac_j._discover_layers(params, single),
                   kfac_t.loss.hamil.n_down)


def test_factor_sums_match_jax(runs):
    """The port's factor sums at the start against JAX's
    ``value_grad_and_taps`` + ``factor_sums`` inside its first step: its
    factors after step 0 are those sums over the rows, times 1 - ema (the
    moving average starts at 0)."""
    case, kfac_j, kfac_t, wf, pcs, out = runs
    wf.load_state_dict(state_dict_from_jax(out[0]['before'][0], wf))
    weight = torch.ones(len(pcs[0].r), dtype=torch.float64)
    (_, (E, _, _)), _, sums = kfac_t.loss.value_grad_and_taps(pcs[0], weight)
    assert_close(E, np.asarray(out[0]['E_j'])[0, 0], REL, 'E_loc')
    want = out[0]['state_j']['factors'][0]
    assert set(sums) == set(want)
    for m in kfac_t.metas:
        rows = len(weight) * sum(m.repeats)
        for got, factor, which in zip(sums[m.path], want[m.path], 'AG'):
            assert_close(got, np.asarray(factor) * rows / (1 - kfac_j.curvature_ema), REL,
                         f'{case}: {which} of {m.path}')


def _assert_params(got: dict, want: dict, wf, what):
    paths = jax_param_paths(wf)
    for key, value in got.items():
        path, name = paths[key]
        assert_close(value, want[path][name], REL_STEP, f'{what}: {path}/{name}')


def test_kfac_steps_match_jax(runs):
    case, kfac_j, kfac_t, wf, _, out = runs
    _assert_layers(kfac_t.metas, kfac_j._layer_meta, kfac_t.loss.hamil.n_down)
    for step, o in enumerate(out):
        what = f'{case} step {step}'
        _assert_params(o['params_t'], o['params_j'], wf, what)
        assert_close(o['E_t'], np.asarray(o['E_j'])[0, 0], REL, f'{what}: E_loc')
        assert set(o['stats_t']) == set(o['stats_j'])
        for k, v in o['stats_j'].items():
            assert_close(o['stats_t'][k], v, REL_STEP, f'{what}: {k}')
        scale = o['stats_t']['opt/norm_scale'].item()
        assert (scale < 1.0) if case == 'binding' else (scale == 1.0), (what, scale)
        assert o['state_t']['step'] == step + 1
        assert o['state_t']['ema_weight'] == pytest.approx(float(o['state_j']['ema_weight']),
                                                           rel=1e-14)
        for key in ('factors', 'inverses'):
            want = o['state_j'][key][0]
            assert set(o['state_t'][key]) == set(want)
            for path, pair in want.items():
                for got_m, want_m in zip(o['state_t'][key][path], pair):
                    assert_close(got_m, want_m, REL_STEP, f'{what}: {key} of {path}')
    # the inverses are carried at step 1 and refreshed at step 2
    carried, refreshed = out[1]['state_t']['inverses'], out[2]['state_t']['inverses']
    first = out[0]['state_t']['inverses']
    assert all(torch.equal(carried[p][0], first[p][0]) for p in first)
    assert not any(torch.equal(refreshed[p][0], first[p][0]) for p in first)


def test_step_from_converted_jax_state(runs):
    """JAX's parameters and KFAC state after step 0, converted: the port's
    step 1 (carried inverses) gives JAX's step 1."""
    case, kfac_j, kfac_t, wf, pcs, out = runs
    params, state_j = out[1]['before']
    wf.load_state_dict(state_dict_from_jax(params, wf))
    state = kfac_state_from_jax(jax.device_get(state_j), kfac_t.metas, wf)
    assert state['step'] == 1
    state, (E, _, _), stats = kfac_t.step(state, pcs[1], torch.ones(len(pcs[1].r),
                                                                    dtype=torch.float64))
    _assert_params(wf.state_dict(), out[1]['params_j'], wf, f'{case} from JAX state')
    assert_close(E, np.asarray(out[1]['E_j'])[0, 0], REL, 'E_loc')
    for k, v in out[1]['stats_j'].items():
        assert_close(stats[k], v, REL_STEP, k)


def test_instrumentation_is_scoped_to_its_context():
    """Dense layers record only inside ``instrumented``: nothing before or
    after it, and a forward-Laplacian pass inside it is refused."""
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    wf = dqt.psiformer_ansatz(hamil, **SMALL)
    pc = hamil.init_sample(torch.Generator().manual_seed(0), 2, dtype=torch.float32)
    with torch.no_grad(), instrumented(wf) as taps:
        wf(pc)
    assert len(taps.calls) == 15 and all(len(c) == 1 for c in taps.calls.values())
    assert all(m.taps is None for m in wf.modules() if hasattr(m, 'jax_name'))
    with torch.no_grad():
        wf(pc)
        with instrumented(wf), pytest.raises(TypeError, match='plain tensors'):
            wf(pc.replace(r=FL.seed(pc.r)))
    assert len(taps.calls) == 15
