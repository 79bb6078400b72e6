"""The port's clipping, energy terms and VMC loss against the JAX package at
float64: the clip functions on odd and even batches (the median of an even
batch interpolates), the closed-form cotangent against the estimator's linear
map, and the loss with its gradient against ``create_loss_fn(...).value_and_grad``
on the small PsiFormer with the same parameters and walkers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_close,
    grads_by_jax_path,
    jax_batch,
    jax_model,
    torch_model,
    torch_phys_conf,
    walkers,
)

from deepqmc_tpu.loss import clip as jax_clip
from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
from deepqmc_tpu.loss import energy as jax_energy
from deepqmc_tpu_torch import parallel
from deepqmc_tpu_torch.loss import clip, create_loss_fn, energy

REL = 1e-10


def _energies(B, seed):
    """Local-energy-like values with a fat tail: most near -8, a few far out."""
    rng = np.random.default_rng(seed)
    x = -8.0 + 0.3 * rng.normal(size=B)
    x[rng.choice(B, 2, replace=False)] += np.array([-40.0, 25.0])
    return x


@pytest.mark.parametrize('B', [7, 8])
def test_median_and_quantile_interpolate_as_jax(B):
    x = _energies(B, B)
    assert_close(parallel.all_device_median(torch.tensor(x)), jnp.median(x), 1e-15)
    for q in (0.95, 0.5, 0.1):
        assert_close(parallel.all_device_quantile(torch.tensor(x), q), jnp.quantile(x, q), 1e-15)
    if B % 2 == 0:  # the lower middle value is not the median of an even batch
        assert torch.median(torch.tensor(x)).item() != pytest.approx(float(jnp.median(x)))


@pytest.mark.parametrize('B', [7, 8])
@pytest.mark.parametrize('fn, kwargs', [
    ('median_log_squeeze_and_mask', {}),
    ('median_log_squeeze_and_mask', dict(clip_width=0.5, quantile=0.5, exclude_width=3.0)),
    ('median_clip_and_mask', dict(clip_width=5.0, median_center=True)),
    ('median_clip_and_mask', dict(clip_width=1.0, median_center=True, exclude_width=4.0)),
    ('median_clip_and_mask', dict(clip_width=1.0, median_center=False, exclude_width=20.0)),
])
def test_clip_functions_match_jax(fn, kwargs, B):
    x = _energies(B, 10 + B)
    got, got_mask = getattr(clip, fn)(torch.tensor(x), **kwargs)
    want, want_mask = getattr(jax_clip, fn)(jnp.asarray(x), **kwargs)
    assert_close(got, want, REL, fn)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    if 'exclude_width' in kwargs:
        assert 0 < got_mask.sum() < B  # the mask drops some walkers and keeps others


@pytest.mark.parametrize('B', [7, 8])
def test_energy_terms_match_jax(B):
    rng = np.random.default_rng(B)
    E, w, T = _energies(B, B), rng.uniform(0.5, 1.5, B), rng.normal(size=B)
    mask = np.arange(B) % 3 != 1
    args = (torch.tensor(E), torch.tensor(w), torch.tensor(T), torch.tensor(mask))
    want = jax_energy.compute_mean_energy_tangent(*map(jnp.asarray, (E, w, T, mask)))
    assert_close(energy.compute_mean_energy_tangent(*args), want, REL)
    assert_close(energy.compute_mean_energy(args[0], args[1])[0],
                 jax_energy.compute_mean_energy(jnp.asarray(E), jnp.asarray(w))[0], REL)
    # the cotangent is the transpose of the tangent's linear map
    c = energy.compute_mean_energy_cotangent(args[0], args[1], args[3])
    (c_jax,) = jax.linear_transpose(
        lambda t: jax_energy.compute_mean_energy_tangent(E, w, t, mask),
        jax.ShapeDtypeStruct((B,), jnp.float64),
    )(1.0)
    assert_close(c, c_jax, REL)
    assert_close((c * args[2]).sum(), want, REL)


def _loss_pair(mol, B, clip_fn, clip_kwargs, seed=0):
    hamil_j, ansatz, params = jax_model(mol, seed=seed)
    hamil_t, wf = torch_model(mol, params)
    r = walkers(hamil_j, 'init_sample', n=B, seed=seed)
    fn_j = lambda x: getattr(jax_clip, clip_fn)(x, **clip_kwargs)  # noqa: E731
    fn_t = lambda x: getattr(clip, clip_fn)(x, **clip_kwargs)  # noqa: E731
    loss_j = jax_create_loss_fn(hamil_j, ansatz, fn_j)
    loss_t = create_loss_fn(hamil_t, wf, fn_t)
    return (loss_j, params, jax_batch(hamil_j, r)), (loss_t, wf, torch_phys_conf(hamil_t, r))


@pytest.mark.parametrize('mol, B, clip_fn, clip_kwargs', [
    ('H2', 8, 'median_log_squeeze_and_mask', {}),
    ('LiH', 7, 'median_log_squeeze_and_mask', dict(exclude_width=2.0)),
    ('Li', 8, 'median_clip_and_mask', dict(clip_width=5.0, median_center=True)),
])
def test_loss_and_gradient_match_jax(mol, B, clip_fn, clip_kwargs):
    (loss_j, params, batch), (loss_t, wf, pc) = _loss_pair(mol, B, clip_fn, clip_kwargs)
    (want_loss, (want_E, _, want_stats)), (want_grads,) = jax.jit(loss_j.value_and_grad)(
        [params], jax.random.PRNGKey(0), batch)
    weight = torch.ones(B, dtype=torch.float64)

    loss, (E, ratio, stats) = loss_t(pc, weight)
    (loss2, (E2, _, _)), grads = loss_t.value_and_grad(pc, weight)
    assert ratio is None
    for got_loss, got_E in ((loss, E), (loss2, E2)):
        assert_close(got_loss, want_loss, REL, 'loss')
        assert_close(got_E, np.asarray(want_E)[0, 0], REL, 'E_loc')
    assert float(want_stats.pop('hamil/V_nl')[0, 0]) == 0.0  # all-electron: no ECP term
    assert set(stats) == set(want_stats)
    for k, v in want_stats.items():
        assert_close(stats[k], np.asarray(v)[0, 0], REL, k)

    got = grads_by_jax_path(grads, wf)
    want = {(p, n): g for p, bundle in want_grads.items() for n, g in bundle.items()}
    assert set(got) == set(want)
    for key, g in want.items():
        assert_close(got[key], g, REL, '/'.join(key))
    assert all(torch.count_nonzero(g) for g in grads.values())


def test_penalties_are_not_ported():
    """The penalties are ported (``tests/test_torch_excited_loss.py``); the
    overlap penalty of several states still refuses a loss without its
    ``alpha`` or its ratio clip."""
    from deepqmc_tpu_torch.wf import StateStack

    stack = StateStack([torch.nn.Linear(1, 1), torch.nn.Linear(1, 1)])
    for kwargs in ({'spin_penalty': 0.1}, {'alpha': 4.0}):
        with pytest.raises(ValueError, match='alpha and clip_mask_overlap_fn'):
            create_loss_fn(None, stack, clip.median_log_squeeze_and_mask, **kwargs)
