"""A small PsiFormer's local energy at float32 under each Jacobian lever.

The port (forward Laplacian, plain kernels on the CPU) and the JAX package
(its forward-Laplacian interpreter, Pallas kernels off on the CPU) take the
local energy of the same 32 LiH walkers with the same parameters at float32,
both under the same ``DEEPQMC_TPU_JAC_DTYPE`` / ``DEEPQMC_TPU_JAC_MATMUL``,
against the float64 local energy without levers (errors relative to
max(1, |E_loc|)).

The JAX package's own band for its bf16 store (``tests/test_fwdlap.py``,
5e-2, on a small function) does not bound a PsiFormer's local energy walker
by walker, for either package: the Laplacian sums 3N second derivatives, and
near a node of psi the inverse Slater matrices amplify bf16 rounding of the
Jacobians (on these walkers JAX's worst error under the bf16 store is 0.31,
the port's 0.16).  So the band holds the median over the walkers, for each
package and between them, and the port's worst walker may be at most twice
JAX's worst plus the band: the port rounds at the same ops as JAX, so it is
no less accurate.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_parity import jax_model, jax_phys_conf, jit_once, torch_model, torch_phys_conf, walkers

BAND = 5e-2
# each lever alone: the bf16 store (the contractions follow it, as in JAX)
# and the bf16 contractions on a float32 store
LEVERS = {
    'jac_bf16': {'DEEPQMC_TPU_JAC_DTYPE': 'bf16'},
    'bf16_products': {'DEEPQMC_TPU_JAC_DTYPE': 'f32', 'DEEPQMC_TPU_JAC_MATMUL': 'bf16'},
}


@pytest.fixture(scope='module')
def model():
    hamil_j, ansatz, params = jax_model('LiH', seed=1)
    r = walkers(hamil_j, 'init_sample', n=32, seed=5)
    pc64 = jax_phys_conf(hamil_j, r)

    def eloc_jax(params, pc):
        e, _ = jit_once(jax.vmap(hamil_j.local_energy(ansatz.apply), (None, None, 0)))(
            None, params, pc)
        return np.asarray(e, np.float64)

    ref = eloc_jax(params, pc64)
    hamil_t, wf64 = torch_model('LiH', params)
    return hamil_j, ansatz, params, r, ref, eloc_jax, hamil_t, wf64.to(torch.float32)


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize('lever', sorted(LEVERS))
def test_local_energy_under_lever_within_band(monkeypatch, model, lever):
    hamil_j, ansatz, params, r, ref, eloc_jax, hamil_t, wf32 = model
    for k, v in LEVERS[lever].items():
        monkeypatch.setenv(k, v)
    pc_j = jax_phys_conf(hamil_j, r.astype(np.float32))
    pc_j = dataclasses.replace(pc_j, R=pc_j.R.astype(np.float32))
    got_j = eloc_jax(_f32(params), pc_j)
    pc_t = torch_phys_conf(hamil_t, r)
    pc_t = pc_t.replace(R=pc_t.R.float(), r=pc_t.r.float())
    with torch.inference_mode():
        got_t, _ = hamil_t.local_energy(wf32, pc_t)
    got_t = got_t.double().numpy()
    scale = np.maximum(1.0, np.abs(ref))
    err_j, err_t = np.abs(got_j - ref) / scale, np.abs(got_t - ref) / scale
    assert np.median(err_j) <= BAND and np.median(err_t) <= BAND
    assert np.median(np.abs(got_t - got_j) / scale) <= BAND
    assert err_t.max() <= 2 * err_j.max() + BAND
