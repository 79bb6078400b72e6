"""The port's SCF pretraining against the JAX package's at float64 on the CPU:
its Boys function against ``scipy.special.hyp1f1``, ``compute_scf_solution``,
the GTO basis, the pretraining target and the ansatz's orbitals
(``return_mos``), the pretraining loss and one Adam and one LAMB update from
the same parameters and walkers, and the two gradient transformations over
five steps against ``optax``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.special import hyp1f1
from torch_parity import assert_close, jax_batch, jax_phys_conf, models, torch_phys_conf

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt
from deepqmc_tpu import nn as jax_nn
from deepqmc_tpu.pretrain import PretrainTarget as JaxPretrainTarget
from deepqmc_tpu.pretrain import compute_scf_solution as jax_compute_scf_solution
from deepqmc_tpu.pretrain import pretrain as jax_pretrain
from deepqmc_tpu.pretrain.gto import GTOBasis as JaxGTOBasis
from deepqmc_tpu.utils import tree_stack, tree_unstack
from deepqmc_tpu_torch.nn import jax_param_paths
from deepqmc_tpu_torch.optimizer import adam, lamb
from deepqmc_tpu_torch.pretrain import PretrainTarget, compute_scf_solution
from deepqmc_tpu_torch.pretrain.gto import GTOBasis
from deepqmc_tpu_torch.pretrain.integrals import boys
from deepqmc_tpu_torch.pretrain.pretraining import pretrain_update
from deepqmc_tpu_torch.physics import pairwise_diffs

REL = 1e-10


def test_boys_function_matches_hyp1f1():
    """F_m(T) over m = 0..8 and T from 0 to 60 (0 included), relative 1e-12;
    both branches (series below T = 30, erf and recursion above) are taken."""
    T = np.concatenate([[0.0, 1e-12, 1e-6], np.linspace(0.0, 60.0, 1201),
                        np.geomspace(1e-4, 60.0, 200)])
    m = np.arange(9)[:, None]
    want = hyp1f1(m + 0.5, m + 1.5, -T) / (2 * m + 1)
    got = boys(m, T)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert isinstance(boys(2, 3.0), float) and boys(3, 0.0) == 1 / 7


_JAX_INTEGRALS = {}


def _jax_dataset(mol_name, monkeypatch=None):
    """(JAX dataset, JAX integrals, port hamiltonian) of the SCF baseline with
    the training configs' basis ('sto-6g'); the integrals are computed once
    per molecule."""
    import deepqmc_tpu.pretrain as jax_pretrain_pkg
    from deepqmc_tpu.pretrain import scf as jax_scf

    hamil_j = dqj.MolecularHamiltonian(mol=dqj.Molecule.from_name(mol_name))
    hamil_t = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name(mol_name))
    if mol_name not in _JAX_INTEGRALS:
        from deepqmc_tpu.pretrain.basis import build_basis

        mol = hamil_j.mol
        shells = build_basis(mol.charges, 'sto-6g')
        _JAX_INTEGRALS[mol_name] = jax_scf.compute_integrals(
            np.asarray(mol.coords), np.asarray(hamil_j.ns_valence), shells)
    ints = _JAX_INTEGRALS[mol_name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pretrain_pkg, 'compute_integrals', lambda *args: ints)
        dataset = jax_compute_scf_solution([hamil_j.mol], hamil_j, 1, basis='sto-6g')
    return dataset, ints, hamil_t


def _as_port_dataset(dataset):
    """A JAX dataset in the port's layout: CPU tensors, orbital indices as long."""
    return {k: v if k == 'shells' else torch.as_tensor(np.array(v)) for k, v in dataset.items()}


# The SCF stops once the commutator FDS - SDF of its density is below 1e-6 (and
# the energy moves by less than 1e-9 Ha); occupied orbitals that pass that test
# are fixed to about 1e-6 over the gap to the first virtual orbital (0.4-1.0 Ha
# for these molecules), so two SCF solutions on integrals that agree to
# rounding may differ by a few 1e-6 and no more.
SCF_ORBITAL_TOL = 1e-5


def _occupied_errors(got, want, n_occ):
    """Largest differences of the occupied orbitals (each up to its sign) and
    of the occupied-space projector C_occ C_occ^T."""
    got, want = got[:, :n_occ], want[:, :n_occ]
    signs = np.sign(np.sum(got * want, axis=0))
    return np.abs(got * signs - want).max(), np.abs(got @ got.T - want @ want.T).max()


def _scf_error(ints, mo_coeff, n_occ):
    """The convergence test's measure of closed-shell orbitals: max |FDS - SDF|."""
    S, Hcore, eri, _ = ints
    D = mo_coeff[:, :n_occ] @ mo_coeff[:, :n_occ].T
    F = Hcore + np.einsum('pqrs,rs->pq', eri, 2 * D) - np.einsum('prqs,rs->pq', eri, D)
    return np.abs(F @ D @ S - S @ D @ F).max()


@pytest.mark.parametrize('mol_name', ['H2', 'LiH', 'H2O'])
def test_scf_solution_matches_jax(mol_name, monkeypatch, tmp_path):
    """Each package's SCF pipeline on its own integrals: the port's integrals
    (its own Boys function) within 1e-14 of JAX's, relative to the largest
    entry, its HF energy within 1e-10 Ha, and the occupied orbitals of its
    ``compute_scf_solution`` (each up to its sign) and their projector within
    ``SCF_ORBITAL_TOL`` of JAX's; the port's orbitals pass the convergence
    test themselves (max |FDS - SDF| below 1e-6); equal centers, shells,
    determinant and coefficient; the solution kept in the workdir is read
    back.

    The occupied orbitals are the pretraining target.  The virtual ones are
    not compared: they are no part of a target without CASCI, and those of
    H2 and H2O are fixed only up to rotations among near-degenerate ones."""
    from deepqmc_tpu.pretrain import scf as jax_scf
    from deepqmc_tpu_torch import pretrain
    from deepqmc_tpu_torch.pretrain import scf

    want, ints_j, hamil_t = _jax_dataset(mol_name)
    mol = hamil_t.mol
    centers, charges, shells = mol.coords, mol.charges, want['shells']
    ints_t = scf.compute_integrals(centers, charges, shells)
    for name, got, ref in zip(ints_t._fields, ints_t, ints_j):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14 * np.abs(ref).max(),
                                   err_msg=name)
    n_up, n_down = hamil_t.n_up, hamil_t.n_down
    e_j = jax_scf.run_hf(centers, charges, shells, n_up, n_down, integrals=ints_j).e_tot
    e_t = scf.run_hf(centers, charges, shells, n_up, n_down, integrals=ints_t).e_tot
    assert abs(e_t - e_j) < 1e-10

    # the port's own integrals, computed once above
    monkeypatch.setattr(pretrain, 'compute_integrals', lambda *args: ints_t)
    got = compute_scf_solution([mol], hamil_t, 1, basis='sto-6g', workdir=str(tmp_path))
    got_mo, want_mo = got['mo_coeffs'][0].numpy(), np.asarray(want['mo_coeffs'][0])
    orbital_err, projector_err = _occupied_errors(got_mo, want_mo, n_up)
    scf_err = _scf_error(ints_t, got_mo, n_up)
    print(f'{mol_name}: occupied orbitals {orbital_err:.2e}, projector {projector_err:.2e}; '
          f'max |FDS - SDF| port {scf_err:.2e}, JAX {_scf_error(ints_j, want_mo, n_up):.2e}')
    assert orbital_err < SCF_ORBITAL_TOL and projector_err < SCF_ORBITAL_TOL
    assert scf_err < 1e-6
    np.testing.assert_array_equal(got['centers'].numpy(), np.asarray(want['centers']))
    assert got['shells'] == want['shells']
    np.testing.assert_array_equal(got['confs'].numpy(), np.asarray(want['confs']))
    np.testing.assert_array_equal(got['conf_coeffs'].numpy(), np.asarray(want['conf_coeffs']))
    assert (tmp_path / 'scf_chkpts' / 'mol_0.npz').exists()
    monkeypatch.undo()
    again = compute_scf_solution([mol], hamil_t, 1, basis='sto-6g', workdir=str(tmp_path))
    assert torch.equal(again['mo_coeffs'], got['mo_coeffs'])


def test_casci_targets_are_not_ported(tmp_path):
    """CASCI targets are ported (``tests/test_torch_casci.py``): H2's (2, 2)
    active space gives its four determinants, and a kept solution of other
    CASCI settings is refused."""
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    ds = compute_scf_solution([hamil.mol], hamil, 1, cas=(2, 2), workdir=str(tmp_path))
    assert tuple(ds['confs'].shape) == (1, 1, 4, 2)
    with pytest.raises(ValueError, match='different'):
        compute_scf_solution([hamil.mol], hamil, 1, workdir=str(tmp_path))


def test_basis_target_and_orbitals_match_jax():
    """On 16 LiH walkers and JAX's SCF solution: the AO values of
    ``GTOBasis``, the SCF target's determinant orbitals and the ansatz's orbitals (``return_mos=True``,
    ``[B, n_det, n_spin, n_orb]`` per spin), each within 1e-10 of JAX's."""
    hamil_j, ansatz, params, hamil_t, wf, r = models('LiH')
    want_ds = _jax_dataset('LiH')[0]
    got_ds = _as_port_dataset(want_ds)
    pc_j, pc_t = jax_phys_conf(hamil_j, r), torch_phys_conf(hamil_t, r)

    diffs = pairwise_diffs(pc_t.r, pc_t.R)
    basis = jax_nn.transform(lambda d: JaxGTOBasis(want_ds['centers'], want_ds['shells'])(d))
    basis_params = basis.init(jax.random.PRNGKey(0), jnp.asarray(diffs.numpy()))
    want_aos = basis.apply(basis_params, jnp.asarray(diffs.numpy()))
    got_aos = GTOBasis(got_ds['centers'], got_ds['shells'])(diffs)
    assert_close(got_aos, want_aos, REL, 'AO values')

    target_j = JaxPretrainTarget(hamil_j, None, want_ds['centers'], want_ds['shells'],
                                 want_ds['mo_coeffs'])
    want_target = jax.vmap(lambda pc: target_j(want_ds['confs'][:, 0],
                                               want_ds['conf_coeffs'][:, 0], pc))(pc_j)
    target_t = PretrainTarget(hamil_t, None, got_ds['centers'], got_ds['shells'],
                              got_ds['mo_coeffs'])
    got_target = target_t(got_ds['confs'][:, 0], got_ds['conf_coeffs'][:, 0], pc_t)
    assert_close(got_target, want_target, REL, 'target orbitals')

    want_mos = jax.vmap(lambda pc: ansatz.apply(params, pc, True))(pc_j)
    with torch.no_grad():
        got_mos = wf(pc_t, return_mos=True)
    for spin, got, want in zip(('up', 'down'), got_mos, want_mos):
        assert_close(got, want, REL, f'{spin} orbitals')


class _FixedSampler:
    """JAX's sampler interface, always returning the same walkers."""

    def __init__(self, phys_conf):
        self.phys_conf = phys_conf

    def sample(self, rng, state, params, mol_idxs):
        return state, self.phys_conf, {}


class _FirstMolecule:
    n_mols = 1

    def sample(self):
        return jnp.array([0])


@pytest.mark.parametrize('opt_name', ['adam', 'lamb'])
def test_pretrain_update_matches_jax(opt_name):
    """One pretraining update of the small LiH PsiFormer (2 determinants
    against the SCF target's one, so the target is tiled; full determinants,
    so the off-diagonal spin blocks are pretrained to zero) from the same
    parameters on the same 16 walkers, with the training configs' optimizer
    settings (lr 3e-4, b1 0.9, b2 0.999): the per-walker losses, the loss and
    every updated parameter within 1e-10 of JAX's ``pretrain`` step (both on
    JAX's SCF solution)."""
    hamil_j, ansatz, params, hamil_t, wf_shared, r = models('LiH')
    want_ds = _jax_dataset('LiH')[0]
    got_ds = _as_port_dataset(want_ds)
    kwargs = dict(learning_rate=3e-4, b1=0.9, b2=0.999)
    pc_j = jax_batch(hamil_j, r)[0]
    ((_, want_params, want_losses, _),) = list(jax_pretrain(
        jax.random.PRNGKey(0), hamil_j, ansatz, tree_stack([params]),
        getattr(optax, opt_name)(**kwargs), _FirstMolecule(), _FixedSampler(pc_j), {},
        want_ds, steps=range(1)))
    (want_params,) = tree_unstack(want_params)

    wf = dqt.psiformer_ansatz(hamil_t, n_determinants=2, embedding_dim=32, n_interactions=2,
                              num_heads=2).double()
    wf.load_state_dict(wf_shared.state_dict())
    target_t = PretrainTarget(hamil_t, None, got_ds['centers'], got_ds['shells'],
                              got_ds['mo_coeffs'])
    opt = {'adam': adam, 'lamb': lamb}[opt_name](**kwargs)
    _, loss, losses = pretrain_update(
        hamil_t, wf, target_t, got_ds['confs'][:, 0], got_ds['conf_coeffs'][:, 0],
        torch_phys_conf(hamil_t, r), opt, opt.init(dict(wf.named_parameters())))
    assert_close(losses, np.asarray(want_losses)[0, 0], REL, 'per-walker losses')
    assert_close(loss, np.asarray(want_losses).mean(), REL, 'loss')
    paths = jax_param_paths(wf)
    unmoved = set()
    for key, value in wf.state_dict().items():
        path, name = paths[key]
        assert_close(value, want_params[path][name], REL, f'{path}/{name}')
        if torch.equal(value, wf_shared.state_dict()[key]):
            unmoved.add(key)
    # the electronic cusp is no part of the orbitals: its gradient is zero
    assert unmoved == {k for k in paths if k.startswith('cusp_electrons.')}


@pytest.mark.parametrize('opt_name', ['adam', 'lamb'])
def test_gradient_transformations_match_optax_over_five_steps(opt_name):
    """Five updates of ``adam``/``lamb`` against ``optax.adam``/``optax.lamb``
    on seeded parameters and gradients (1e-12), LAMB's trust ratio with its
    zero-norm cases: a parameter of zeros and a gradient of zeros."""
    rng = np.random.default_rng(0)
    shapes = {'w': (4, 3), 'b': (3,), 'zero_param': (2, 2), 'zero_grad': (5,)}
    params = {k: rng.normal(size=s) for k, s in shapes.items()}
    params['zero_param'][:] = 0.0
    grads = [{k: rng.normal(size=s) * (k != 'zero_grad') for k, s in shapes.items()}
             for _ in range(5)]
    kwargs = dict(learning_rate=3e-4, b1=0.9, b2=0.999)
    want_opt = getattr(optax, opt_name)(**kwargs)
    got_opt = {'adam': adam, 'lamb': lamb}[opt_name](**kwargs)
    want_params = {k: jnp.asarray(v) for k, v in params.items()}
    got_params = {k: torch.tensor(v) for k, v in params.items()}
    want_state, got_state = want_opt.init(want_params), got_opt.init(got_params)
    for step, g in enumerate(grads):
        updates, want_state = want_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                              want_state, want_params)
        want_params = optax.apply_updates(want_params, updates)
        got_updates, got_state = got_opt.update({k: torch.tensor(v) for k, v in g.items()},
                                                got_state, got_params)
        got_params = {k: p + got_updates[k] for k, p in got_params.items()}
        for k in shapes:
            np.testing.assert_allclose(got_params[k].numpy(), np.asarray(want_params[k]),
                                       rtol=1e-12, atol=1e-15, err_msg=f'step {step}: {k}')
    assert not np.array_equal(got_params['zero_param'].numpy(), params['zero_param'])
