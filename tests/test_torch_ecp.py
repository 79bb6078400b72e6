"""The port's effective core potentials (``deepqmc_tpu_torch/ecp/``, the ECP
terms of ``hamil.MolecularHamiltonian``) against the JAX package at float64.

The packaged tables against the JAX package's GAMESS files; the quadrature
points; the local and nonlocal potentials on the synthetic Li ECP of
``tests/test_ecp.py`` (LiH) and the packaged O ccECP (H2O) under the small
PsiFormer, with JAX's quadrature angles (``jax.random.fold_in(key, k)``
per ECP nucleus) fed to the port, within 1e-10 relative; independence of
the walker chunks; the LiH local energy with ECP; valence counts, shells and
the Sc disclosure of ScO; each preset's psi on an ECP Hamiltonian; the SCF
of pretraining on valence charges; the precedence of the table sources.
"""

import functools
import logging
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_phys_conf, jit_once, small_kwargs, torch_phys_conf

import deepqmc_tpu as dqj
import deepqmc_tpu_torch as dqt
from deepqmc_tpu.ecp import data as jax_data
from deepqmc_tpu.ecp import ecp_utils as jax_utils
from deepqmc_tpu.presets import ansatz_preset as jax_ansatz_preset
from deepqmc_tpu.wf import instantiate_ansatz
from deepqmc_tpu_torch.convert import state_dict_from_jax
from deepqmc_tpu_torch.ecp import data, ecp_utils, gaussian_type_ecp
from deepqmc_tpu_torch.ecp.tables import REFIT_TABLES, TABLES

RTOL = 1e-10
ELOC_RTOL = 1e-9  # as tests/test_torch_hamil.py: the local energy's FL sums
TABLE_DIR = Path(dqj.__file__).parent / 'ecp' / 'tables'

# tests/test_ecp.py's synthetic Li (He core, Z_eff = 1), under a type of its own
LI_LOCAL = [[[3.5, 1.2]], [[2.8, 6.5]], [[2.0, -1.1]]]
LI_NONLOCAL = [[[2.2, 3.0]]]
for _register in (jax_data.register_ecp_params, data.register_ecp_params):
    _register('porttestecp', 3, 2, LI_LOCAL, LI_NONLOCAL)


def _files(directory, ecp_type):
    return {f.name.split('.')[0]: f for f in sorted(directory.glob(f'*.{ecp_type}.gamess'))}


@pytest.mark.parametrize('ecp_type', ['ccECP', 'bfd'])
def test_tables_match_the_jax_files(ecp_type):
    """Every packaged table, default and refit, parses to the JAX file's
    parameters; the IN-HOUSE mark stays where the file has it."""
    for port, directory in ((TABLES, TABLE_DIR), (REFIT_TABLES, TABLE_DIR / 'refit')):
        files = _files(directory, ecp_type)
        assert set(port.get(ecp_type, {})) == set(files)
        for sym, f in files.items():
            text = f.read_text()
            assert data.parse_gamess_ecp(port[ecp_type][sym]) == jax_data.parse_gamess_ecp(text)
            assert ('IN-HOUSE' in port[ecp_type][sym]) == ('IN-HOUSE' in text)


def test_tables_module_is_small():
    assert Path(data.__file__).with_name('tables.py').stat().st_size < 3000


def test_parser_refuses_what_jax_refuses():
    bad = 'X-ECP GEN 2 1\n1\n1.0 4 2.0\n1\n1.0 2 1.0\n'
    with pytest.raises(AssertionError):
        jax_data.parse_gamess_ecp(bad)
    with pytest.raises(ValueError, match='r-power'):
        data.parse_gamess_ecp(bad)


def _jax_angles(key, n_nl, n):
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, k), (n,),
                                                   minval=0, maxval=jnp.pi / 5))
                     for k in range(n_nl)])


def test_quadrature_points_match_jax():
    rng = np.random.default_rng(0)
    r, nucleus = rng.normal(size=(5, 3)), rng.normal(size=3)
    key = jax.random.PRNGKey(4)
    pc = dqj.types.PhysicalConfiguration(jnp.asarray(nucleus[None]), jnp.asarray(r),
                                         jnp.array(0))
    want = jax_utils.get_quadrature_points(key, jnp.asarray(nucleus), pc).r
    phi = np.asarray(jax.random.uniform(key, (5,), minval=0, maxval=jnp.pi / 5))
    got = ecp_utils.get_quadrature_points(torch.tensor(nucleus), torch.tensor(r)[None],
                                          torch.tensor(phi)[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)
    np.testing.assert_array_equal(ecp_utils.get_unit_icosahedron_sph(),
                                  np.asarray(jax_utils.get_unit_icosahedron_sph()))


def test_legendre_values_match_jax():
    """ScO's channels s and p (Sc): numpy's Legendre series against
    JAX's ``scipy.special.legendre`` at the vertices' polar angles."""
    from deepqmc_tpu.ecp.gaussian_type_ecp import GaussianTypeECP as JaxECP

    got = gaussian_type_ecp.GaussianTypeECP([21, 8], 'ccECP', [True, True])
    want = JaxECP(np.array([21, 8]), 'ccECP', np.array([True, True]))
    assert got.legendre_values.shape == (12, 2)
    np.testing.assert_allclose(got.legendre_values, want.legendre_values, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(got.nuc_with_nl_pot, want.nuc_with_nl_pot)


def models(mol_name, ecp_type, ecp_mask=None, preset='psiformer', seed=0, **overrides):
    """(JAX hamiltonian, ansatz, params) and (port hamiltonian, float64 wave
    function holding the same parameters) of the small ``preset`` with ECPs."""
    hamil_j = dqj.MolecularHamiltonian(mol=dqj.Molecule.from_name(mol_name),
                                       ecp_type=ecp_type, ecp_mask=ecp_mask)
    ansatz = instantiate_ansatz(hamil_j, jax_ansatz_preset(preset,
                                                           **small_kwargs(preset, **overrides)))
    pc = hamil_j.init_sample(jax.random.PRNGKey(seed), hamil_j.mol.coords, 1)[0]
    params = jit_once(ansatz.init)(jax.random.PRNGKey(seed + 1), pc)
    noise = np.random.default_rng(seed)
    params = {path: {k: np.asarray(v) + 0.1 * noise.normal(size=np.shape(v))
                     for k, v in bundle.items()} for path, bundle in params.items()}
    hamil_t = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name(mol_name), ecp_type=ecp_type,
                                       ecp_mask=ecp_mask)
    wf = dqt.ansatz_preset(preset, **small_kwargs(preset, **overrides))(hamil_t)
    wf = wf.to(torch.float64)
    wf.load_state_dict(state_dict_from_jax(params, wf))
    return hamil_j, ansatz, params, hamil_t, wf


CASES = {'LiH-synthetic': ('LiH', 'porttestecp', [True, False]),
         'H2O-ccECP': ('H2O', 'ccECP', None)}


@pytest.fixture(scope='module', params=list(CASES))
def case(request):
    mol, ecp_type, mask = CASES[request.param]
    hamil_j, ansatz, params, hamil_t, wf = models(mol, ecp_type, mask)
    r = np.asarray(hamil_j.init_sample(jax.random.PRNGKey(3), hamil_j.mol.coords, 3).r)
    # drawn toward the ECP nucleus (the first), where its Gaussians are large
    R0 = np.asarray(hamil_j.mol.coords)[0]
    r = R0 + 0.4 * (r - R0)
    keys = jax.random.split(jax.random.PRNGKey(5), len(r))
    pc_j = jax_phys_conf(hamil_j, r)
    pot = hamil_j.potential
    wf_j = functools.partial(ansatz.apply, params)

    def one(key, pc):
        return pot.local_potential(pc), pot.nonloc_potential(key, pc, wf_j)

    v_loc, v_nl = jax.jit(jax.vmap(one))(keys, pc_j)
    eloc, stats = jit_once(jax.vmap(hamil_j.local_energy(ansatz.apply), (0, None, 0)))(
        keys, params, pc_j)
    n_nl = len(pot.nuc_with_nl_pot)
    phi = np.stack([_jax_angles(k, n_nl, r.shape[1]) for k in keys], axis=1)  # [n_nl, B, n]
    return dict(hamil_j=hamil_j, hamil_t=hamil_t, wf=wf, r=r, phi=torch.tensor(phi),
                v_loc=np.asarray(v_loc), v_nl=np.asarray(v_nl), eloc=np.asarray(eloc),
                stats={k: np.asarray(v) for k, v in stats.items()})


def test_potentials_match_jax(case):
    h = case['hamil_t']
    pc = torch_phys_conf(h, case['r'])
    assert np.abs(case['v_nl']).min() > 1e-6  # the nonlocal part is resolved
    v_loc = h.ecp.local_potential(pc.r, pc.R)
    with torch.inference_mode():
        v_nl = h.ecp.nonloc_potential(pc, case['wf'], phi=case['phi'])
    np.testing.assert_allclose(v_loc.numpy(), case['v_loc'], rtol=RTOL)
    np.testing.assert_allclose(v_nl.numpy(), case['v_nl'], rtol=RTOL)


def test_nonlocal_does_not_depend_on_the_chunks(case):
    h = case['hamil_t']
    pc = torch_phys_conf(h, case['r'])
    n = pc.r.shape[1]
    with torch.inference_mode():
        whole = h.ecp.nonloc_potential(pc, case['wf'], phi=case['phi'], chunk=10**6)
        one_walker = h.ecp.nonloc_potential(pc, case['wf'], phi=case['phi'], chunk=12 * n)
        two = h.ecp.nonloc_potential(pc, case['wf'], phi=case['phi'], chunk=24 * n + 1)
    np.testing.assert_allclose(one_walker.numpy(), whole.numpy(), rtol=1e-13)
    np.testing.assert_allclose(two.numpy(), whole.numpy(), rtol=1e-13)


def test_local_energy_matches_jax(case):
    h = case['hamil_t']
    with torch.inference_mode():
        eloc, stats = h.local_energy(case['wf'], torch_phys_conf(h, case['r']), phi=case['phi'])
    np.testing.assert_allclose(eloc.numpy(), case['eloc'], rtol=ELOC_RTOL)
    assert set(stats) == set(case['stats'])
    for key, value in case['stats'].items():
        np.testing.assert_allclose(stats[key].numpy(), value, rtol=ELOC_RTOL, err_msg=key)


def test_local_energy_draws_its_own_angles():
    """Without angles the Hamiltonian draws them from its own seeded generator
    on the walkers' device: two Hamiltonians of one seed agree, the nonlocal
    term is finite and the rest of E_loc does not move."""
    *_, hamil_t, wf = models('LiH', 'ccECP')
    r = torch.tensor(np.random.default_rng(1).normal(size=(4, 2, 3)))
    pc = torch_phys_conf(hamil_t, r.numpy())
    with torch.inference_mode():
        e1, s1 = hamil_t.local_energy(wf, pc)
        e2, s2 = dqt.MolecularHamiltonian(mol=hamil_t.mol, ecp_type='ccECP').local_energy(wf, pc)
    np.testing.assert_array_equal(e1.numpy(), e2.numpy())
    assert torch.isfinite(s1['hamil/V_nl']).all()
    np.testing.assert_allclose((e1 - s1['hamil/V_nl']).numpy(), (e2 - s2['hamil/V_nl']).numpy())


def test_valence_shells_and_disclosure_of_sco(caplog):
    """ScO with ccECPs on both nuclei: 11 + 6 valence electrons split 9/8,
    the shells of JAX, and the IN-HOUSE warning when the Sc table loads."""
    for registry in (data._REGISTRY, data._SOURCE):
        registry.pop(('ccecp', 21), None)
    with caplog.at_level(logging.WARNING, logger='deepqmc_tpu_torch.ecp.data'):
        h_t = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('ScO'), ecp_type='ccECP')
    assert any('IN-HOUSE' in rec.message and 'Sc' in rec.message for rec in caplog.records)
    h_j = dqj.MolecularHamiltonian(mol=dqj.Molecule.from_name('ScO'), ecp_type='ccECP')
    np.testing.assert_array_equal(h_t.ns_valence, [11.0, 6.0])
    np.testing.assert_array_equal(h_t.ns_valence, np.asarray(h_j.ns_valence))
    assert (h_t.n_up, h_t.n_down) == (h_j.n_up, h_j.n_down) == (9, 8)
    assert h_t.mol_shells == h_j.mol_shells and h_t.mol_ecp_shells == h_j.mol_ecp_shells
    np.testing.assert_array_equal(h_t.ecp_mask, h_j.ecp_mask)
    light = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('LiH'), ecp_type='ccECP')
    np.testing.assert_array_equal(light.ecp_mask, [True, False])  # H stays all-electron
    assert light.mol_ecp_shells == [1, 0]
    with pytest.raises(ValueError, match='ecp_mask'):
        dqt.MolecularHamiltonian(mol=light.mol, ecp_type='ccECP', ecp_mask=[True])


@pytest.mark.parametrize('preset', ['default', 'ferminet', 'psiformer'])
def test_presets_with_ecp_match_jax(preset):
    """Each preset's envelopes on an ECP Hamiltonian (one per nucleus, as the
    presets' ``per_shell=False`` gives whatever ``mol_ecp_shells``): the same
    parameters and psi as JAX on H2O with the O ccECP."""
    hamil_j, ansatz, params, hamil_t, wf = models('H2O', 'ccECP', preset=preset)
    r = np.asarray(hamil_j.init_sample(jax.random.PRNGKey(2), hamil_j.mol.coords, 3).r)
    want = jit_once(jax.vmap(ansatz.apply, (None, 0)))(params, jax_phys_conf(hamil_j, r))
    with torch.inference_mode():
        got = wf(torch_phys_conf(hamil_t, r))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.log.numpy(), np.asarray(want.log), rtol=RTOL)


def test_pretraining_scf_takes_the_valence_charges():
    """LiH with the Li ccECP: the port's SCF dataset holds JAX's occupied
    orbital (2 valence electrons, up to its sign) within the SCF tolerance
    of tests/test_torch_pretrain.py."""
    from deepqmc_tpu.pretrain import compute_scf_solution as jax_scf
    from deepqmc_tpu_torch.pretrain import compute_scf_solution

    h_j = dqj.MolecularHamiltonian(mol=dqj.Molecule.from_name('LiH'), ecp_type='ccECP')
    h_t = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('LiH'), ecp_type='ccECP')
    want = np.asarray(jax_scf([h_j.mol], h_j, 1, basis='sto-6g')['mo_coeffs'])[0][:, :1]
    got = compute_scf_solution([h_t.mol], h_t, 1, basis='sto-6g')['mo_coeffs'].numpy()[0][:, :1]
    got = got * np.sign((got * want).sum())
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sources_take_precedence(monkeypatch, tmp_path):
    """A directory's file beats the packaged table, an explicit registration
    beats both, and the N refit loads only when asked for."""
    key = ('ccecp', 7)

    def fresh():
        for registry in (data._REGISTRY, data._SOURCE):
            registry.pop(key, None)
        data._LOADED_DIRS.clear()

    fresh()
    published = data.get_ecp_params('ccECP', 7)
    assert published == jax_data.parse_gamess_ecp((TABLE_DIR / 'N.ccECP.gamess').read_text())[1:]
    fresh()
    monkeypatch.setenv('DEEPQMC_TPU_ECP_USE_REFIT', 'N')
    refit = data.get_ecp_params('ccECP', 7)
    assert refit == data.parse_gamess_ecp(REFIT_TABLES['ccECP']['N'])[1:] != published
    monkeypatch.delenv('DEEPQMC_TPU_ECP_USE_REFIT')
    fresh()
    (tmp_path / 'N.ccECP.gamess').write_text(
        TABLES['ccECP']['N'].replace('77.74203000', '70.00000000'))
    monkeypatch.setenv('DEEPQMC_TPU_ECP_DIR', str(tmp_path))
    assert data.get_ecp_params('ccECP', 7)[2][0][0][1] == 70.0
    data.register_ecp_params('ccECP', 7, 2, LI_LOCAL, LI_NONLOCAL)
    assert data.get_ecp_params('ccECP', 7)[1] == LI_LOCAL
    monkeypatch.delenv('DEEPQMC_TPU_ECP_DIR')
    fresh()
    with pytest.raises(ValueError, match='No .* ECP parameters'):
        data.get_ecp_params('ccECP', 36)
    assert math.isclose(data.get_ecp_params('ccECP', 7)[2][0][0][1], 77.74203)
