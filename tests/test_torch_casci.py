"""CASCI pretraining targets of the port against the JAX package at float64:
``run_casci`` on the problems of ``tests/test_casci.py`` (H2 on the
even-tempered HF orbitals: a one-determinant space, (4, 2) with three roots,
(2, 2) with all four and with ``fix_spin``, on the same integrals) with its
energies, S^2 and CI vectors up to sign, also with numpy's ``bitwise_count``
hidden (the popcount of older numpy); ``compute_scf_solution(cas=...)`` of
two LiH states ('sto-6g', each package on its own SCF); and one LAMB
pretraining update of two states, each held to its own CASCI root, against
JAX's ``pretrain`` step on JAX's dataset (the norms of LAMB's trust ratio
taken over both states, as JAX's stacked parameters)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import assert_close, jax_model, jax_phys_conf, torch_model, walkers

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt
from deepqmc_tpu.pretrain import compute_scf_solution as jax_compute_scf_solution
from deepqmc_tpu.pretrain import pretrain as jax_pretrain
from deepqmc_tpu.pretrain.basis import build_basis as jax_build_basis
from deepqmc_tpu.pretrain.casci import _mo_eri as jax_mo_eri
from deepqmc_tpu.pretrain.casci import run_casci as jax_run_casci
from deepqmc_tpu.pretrain.scf import compute_integrals as jax_compute_integrals
from deepqmc_tpu.pretrain.scf import run_hf as jax_run_hf
from deepqmc_tpu.utils import tree_stack, tree_unstack
from deepqmc_tpu_torch.nn import jax_param_paths
from deepqmc_tpu_torch.optimizer import lamb
from deepqmc_tpu_torch.pretrain import PretrainTarget, compute_scf_solution
from deepqmc_tpu_torch.pretrain.casci import run_casci
from deepqmc_tpu_torch.pretrain.pretraining import _stacked, pretrain_update
from deepqmc_tpu_torch.types import PhysicalConfiguration
from deepqmc_tpu_torch.wf import StateStack

REL, B = 1e-10, 8
# two SCF solutions on integrals that agree to rounding may differ by a few
# 1e-6 in their orbitals (tests/test_torch_pretrain.py), and the CI vectors on them
SCF_TOL = 1e-5


@pytest.fixture(scope='module')
def h2_problem():
    hamil = dqj.MolecularHamiltonian(mol=dqj.Molecule.from_name('H2'))
    centers, charges = np.asarray(hamil.mol.coords), np.asarray(hamil.ns_valence)
    shells = jax_build_basis(hamil.mol.charges, 'even-tempered')
    ints = jax_compute_integrals(centers, charges, shells)
    hf = jax_run_hf(centers, charges, shells, 1, 1, integrals=ints)
    return (hf.mo_coeff.T @ ints.Hcore @ hf.mo_coeff, jax_mo_eri(ints.eri, hf.mo_coeff),
            ints.e_nuc)


def _assert_casci(got, want):
    assert got.n_core == want.n_core
    np.testing.assert_array_equal(got.up_occs, want.up_occs)
    np.testing.assert_array_equal(got.down_occs, want.down_occs)
    np.testing.assert_allclose(got.energies, want.energies, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.s2, want.s2, rtol=0, atol=1e-10)
    signs = np.sign(np.sum(got.ci_coeffs * want.ci_coeffs, -1, keepdims=True))
    np.testing.assert_allclose(got.ci_coeffs * signs, want.ci_coeffs, rtol=0, atol=1e-10)


CASES = {  # (cas, n_states, fix_spin)
    'one determinant': ((1, 2), 1, None),
    'three roots': ((4, 2), 3, None),
    'all four': ((2, 2), 4, None),
    'singlets': ((2, 2), 3, 0.0),
}


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('popcount', ['bitwise_count', 'loop'])
def test_run_casci_matches_jax(h2_problem, case, popcount, monkeypatch):
    cas, n_states, fix_spin = CASES[case]
    want = jax_run_casci(*h2_problem, 1, 1, cas, n_states=n_states, fix_spin=fix_spin)
    if popcount == 'loop':
        monkeypatch.delattr(np, 'bitwise_count', raising=False)
    got = run_casci(*h2_problem, 1, 1, cas, n_states=n_states, fix_spin=fix_spin)
    _assert_casci(got, want)
    if fix_spin is not None:
        with pytest.raises(ValueError, match='roots with S'):
            run_casci(*h2_problem, 1, 1, cas, n_states=n_states + 1, fix_spin=fix_spin)


def _by_determinant(confs, coeffs):
    """Per state: determinant (orbital indices) -> CI coefficient, the sign
    fixed by the heaviest determinant."""
    out = []
    for c, x in zip(np.asarray(confs), np.asarray(coeffs)):
        sign = np.sign(x[0])
        out.append({tuple(d): sign * v for d, v in zip(c, x)})
    return out


@pytest.fixture(scope='module')
def lih_datasets():
    hamil_j = dqj.MolecularHamiltonian(mol=dqj.Molecule.from_name('LiH'))
    hamil_t = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('LiH'))
    kwargs = dict(basis='sto-6g', cas=(2, 2))
    return (jax_compute_scf_solution([hamil_j.mol], hamil_j, 2, **kwargs),
            compute_scf_solution([hamil_t.mol], hamil_t, 2, **kwargs))


def test_compute_scf_solution_with_cas_matches_jax(lih_datasets):
    """The same determinants per state, sorted by falling weight, with
    coefficients within the SCF's orbital tolerance; a singlet's sector."""
    want, got = lih_datasets
    assert tuple(got['confs'].shape) == np.asarray(want['confs']).shape == (1, 2, 4, 4)
    assert got['confs'].dtype == torch.long and got['conf_coeffs'].dtype == torch.float64
    weights = got['conf_coeffs'].numpy() ** 2
    assert (np.diff(weights, axis=-1) <= 1e-12).all()
    for g, w in zip(_by_determinant(got['confs'][0], got['conf_coeffs'][0]),
                    _by_determinant(want['confs'][0], want['conf_coeffs'][0])):
        assert set(g) == set(w)
        for det, c in w.items():
            assert abs(g[det] - c) < SCF_TOL, (det, g[det], c)


def test_two_state_pretraining_update_matches_jax(lih_datasets):
    """State s of the small PsiFormer (2 determinants, so the target's first 2
    of its 4) against CASCI root s on its own 8 walkers."""
    want_ds = lih_datasets[0]
    got_ds = {k: v if k == 'shells' else torch.as_tensor(np.array(v)) for k, v in want_ds.items()}
    hamil_j, ansatz, params = jax_model('LiH', seed=0)
    params = [params, jax_model('LiH', seed=1)[2]]
    mods = [torch_model('LiH', p) for p in params]
    hamil_t, stack = mods[0][0], StateStack([wf for _, wf in mods])
    before = {k: v.clone() for k, v in stack.state_dict().items()}
    rs = np.stack([walkers(hamil_j, 'init_sample', n=B, seed=20 + s) for s in range(2)])
    kwargs = dict(learning_rate=3e-4, b1=0.9, b2=0.999)

    class FixedSampler:
        def sample(self, rng, state, params, mol_idxs):
            pcs = [jax_phys_conf(hamil_j, r) for r in rs]
            return state, jax.tree_util.tree_map(lambda *x: jnp.stack(x)[None], *pcs), {}

    class FirstMolecule:
        n_mols = 1

        def sample(self):
            return jnp.array([0])

    ((_, want_params, want_losses, _),) = list(jax_pretrain(
        jax.random.PRNGKey(0), hamil_j, ansatz, tree_stack(params), optax.lamb(**kwargs),
        FirstMolecule(), FixedSampler(), {}, want_ds, steps=range(1)))
    target = PretrainTarget(hamil_t, None, got_ds['centers'], got_ds['shells'],
                            got_ds['mo_coeffs'])
    opt = lamb(**kwargs)
    pc = PhysicalConfiguration(torch.as_tensor(hamil_t.mol.coords, dtype=torch.float64),
                               torch.tensor(rs), torch.zeros(2, B, dtype=torch.long))
    _, loss, losses = pretrain_update(hamil_t, stack, target, got_ds['confs'],
                                      got_ds['conf_coeffs'], pc, opt, opt.init(_stacked(stack)))
    assert_close(losses, np.asarray(want_losses)[0], REL, 'per-walker losses')
    assert_close(loss, np.asarray(want_losses).mean(), REL, 'loss')
    for s, want in enumerate(tree_unstack(want_params)):
        paths = jax_param_paths(stack[s])
        for key, value in stack[s].state_dict().items():
            path, name = paths[key]
            assert_close(value, want[path][name], REL, f'state {s} {path}/{name}')
            if not key.startswith('cusp_electrons.'):
                assert not torch.equal(value, before[f'{s}.{key}']), key
