"""The tests of ``test_torch_zoo_tree_options.py`` on its backflow, no-omni and
edge cases: ``backflow_transform`` 'add' and 'both', no ``omni_factory``, and
DeepErwin with the 'nn', 'en' and 'ne' edges, Gaussian features and negative
powers; the same tolerances.  A file of its own, so that neither file's JAX
programs take the suite's time alone."""

import pytest
from test_torch_zoo_tree_options import (  # noqa: F401  (collected here with this file's fixture)
    EDGES,
    HERE,
    TREE_CASES,
    make_tree_case,
    test_tree_options_local_energy_matches_jax,
    test_tree_options_psi_matches_jax,
)


@pytest.fixture(scope='module', params=[*(c for c in TREE_CASES if c not in HERE), EDGES])
def tree_case(request):
    return make_tree_case(request.param)
