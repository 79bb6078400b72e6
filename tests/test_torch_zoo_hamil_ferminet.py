"""The tests of ``test_torch_zoo_hamil.py`` on the FermiNet preset: the local
energy and its terms against JAX and against the port's autograd oracle, the
same cases and tolerances.  A file of its own, so that neither file's JAX
programs take the suite's time alone."""

import pytest
from test_torch_zoo_hamil import (  # noqa: F401  (collected here with this file's fixture)
    CASES,
    make_case,
    test_forward_laplacian_matches_autograd_oracle,
    test_forward_laplacian_matches_jax,
)


@pytest.fixture(scope='module', params=[('ferminet', *c) for c in CASES],
                ids=lambda p: '-'.join(map(str, p)))
def case(request):
    return make_case(*request.param)
