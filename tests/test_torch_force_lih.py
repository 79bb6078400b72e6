"""The tests of ``test_torch_force.py`` on LiH: the five force estimators,
``grad_nuc_log_psi``, the direction chunks, the ac_zv term against JAX's
``directional_grad_wf`` and the tangent pass on inference tensors, against
the JAX package at float64 (tolerances as there).  A file of its own, since
each molecule's JAX programs take about half a minute to compile."""

import pytest
from test_torch_force import (  # noqa: F401  (collected here with this file's fixture)
    make_case,
    test_ac_zv_term_is_the_local_energy_of_the_derivative,
    test_direction_chunks_change_nothing,
    test_estimator_matches_jax,
    test_grad_nuc_log_psi_matches_jax,
    test_tangent_pass_on_inference_tensors,
    test_zvq_contraction_matches_jacobian,
)


@pytest.fixture(scope='module')
def case():
    return make_case('LiH')
