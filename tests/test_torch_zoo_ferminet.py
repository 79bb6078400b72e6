"""``test_torch_zoo.py``'s psi test on the FermiNet preset: the small preset
with full and per-spin determinants on H2, LiH (both walker sources), H2O
and the Li atom; sign exactly, log|psi| to relative 1e-10 at float64.  A
file of its own, so that neither file's JAX programs take the suite's time
alone."""

import pytest
from test_torch_zoo import MOLS, check_psi


@pytest.mark.parametrize('preset, mol, source, full_determinant', [
    ('ferminet', *m, f) for m in MOLS for f in (True, False)
])
def test_psi_matches_jax(preset, mol, source, full_determinant):
    check_psi(preset, mol, source, full_determinant)
