"""The port's named molecules: all 28 geometries of the JAX package's
``conf/hamil/mol/*.yaml``, kept in ``deepqmc_tpu_torch/molecule.py`` as Python
data, against ``deepqmc_tpu.Molecule.from_name`` (coordinates in bohr, charges,
total charge and spin)."""

import numpy as np
import pytest

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt

NAMES = sorted(dqj.Molecule.all_names - {'from_file'})


def test_the_port_knows_every_name():
    assert len(NAMES) == 28
    assert dqt.Molecule.all_names == set(NAMES)


@pytest.mark.parametrize('name', NAMES)
def test_named_molecule_matches_jax(name):
    got, want = dqt.Molecule.from_name(name), dqj.Molecule.from_name(name)
    np.testing.assert_array_equal(got.coords, np.asarray(want.coords))
    np.testing.assert_array_equal(got.charges, np.asarray(want.charges))
    assert (got.charge, got.spin) == (want.charge, want.spin)
