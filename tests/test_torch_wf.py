"""The port's PsiFormer wave function against the JAX package.

The small preset (2 determinants, embedding 32, 2 layers, 2 heads) on H2, LiH,
H2O and the open-shell Li atom (2 up, 1 down) and triplet H2 (2 up, 0 down), with JAX's parameters converted by ``deepqmc_tpu_torch.convert``;
walkers from JAX ``init_sample`` and, for LiH, the pinned self-golden walker.
Sign exactly, log|psi| to relative 1e-10 at float64 (the same network; only
the summation order of the products differs).
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import jax_model, jax_phys_conf, jit_once, torch_model, torch_phys_conf, walkers

from deepqmc_tpu_torch.convert import state_dict_from_jax
from deepqmc_tpu_torch.nn import jax_param_paths

RTOL = 1e-10


@pytest.mark.parametrize(
    'mol, source',
    [('H2', 'init_sample'), ('LiH', 'init_sample'), ('LiH', 'selfgolden'), ('H2O', 'init_sample'),
     ('Li', 'init_sample'), ('H2_triplet', 'init_sample')],
)
def test_psi_matches_jax(mol, source):
    hamil_j, ansatz, params = jax_model(mol)
    hamil_t, wf = torch_model(mol, params)
    r = walkers(hamil_j, source, n=4)
    want = jit_once(jax.vmap(ansatz.apply, (None, 0)))(params, jax_phys_conf(hamil_j, r))
    with torch.inference_mode():
        got = wf(torch_phys_conf(hamil_t, r))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.log.numpy(), np.asarray(want.log), rtol=RTOL)


def test_conversion_covers_every_parameter():
    _, _, params = jax_model('H2O')
    _, wf = torch_model('H2O', params)
    paths = jax_param_paths(wf)
    assert {f'{p}/{n}' for p, n in paths.values()} == {
        f'{p}/{n}' for p, bundle in params.items() for n in bundle
    }
    assert len(paths) == len(list(wf.parameters()))


def test_conversion_rejects_foreign_parameters():
    _, _, params = jax_model('H2')
    _, wf = torch_model('H2', params)
    params['neural_network_wave_function/extra'] = {'w': np.zeros(3)}
    with pytest.raises(KeyError):
        state_dict_from_jax(params, wf)
