"""The components of transferable wave functions in the port against the
JAX package (``tests/test_transferable.py``'s ansatz and its switches).

One tree of partials, written once over either package's classes, builds
three small ansätze (embedding 16, 2 determinants, 2 interactions of
``CombinedNodeAttentionUpdateFeature``) that between them take both modes of
every switch:

- ``head``: atom-type tokens through the 'mlp' nuclear embedding, the
  electron embedding with spin, attention from the nuclei to the electrons,
  a ``NuclearGNNHead`` of zetas and pis feeding
  ``SimplifiedNucleusDependentEnvelopes`` with per-orbital exponents, the
  nuclear cusp with a trainable alpha (LiH);
- ``ghost``: index tokens through the 'embed' table, a ghost nucleus
  (``ghost_coords``), ``PermutationInvariantEmbedding`` of the edge
  features and the nuclear embeddings ('concatenate'), the nuclei attending
  to the nuclei only, the exponential envelopes, the DeepQMC nuclear cusp
  with a fixed alpha (LiH);
- ``geometry``: the geometry-aware nuclear embedding over 'nn' edges,
  ``PermutationInvariantEmbedding`` by 'elementwise-product', a head of
  zetas only with ``fixed_pi`` and one exponent per nucleus (H2O, two
  identical nuclei).

For each: sign exactly and log|psi| to relative 1e-10, E_loc and its terms
(the port's forward Laplacian) to relative 1e-9, at float64 with JAX's
parameters converted by ``deepqmc_tpu_torch.convert``.  The JAX side's
E_loc takes its loop Laplacian (``physics.loop_laplacian``): its forward
Laplacian raises on the head's layer norm (the ``select_n`` of
``jnp.var``; ROADMAP.md, queue 3).  Besides, alone, to relative 1e-12:
the nuclear embedding in its four geometry-free modes,
``PermutationInvariantEmbedding`` in both charge dependences and the
electron embedding as a table and from several positional edge types.
"""

import functools
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import init_sample, jax_phys_conf, jit_once, molecule, torch_phys_conf, walkers

import deepqmc_tpu as dqj
import deepqmc_tpu.gnn.edge_features as jef
import deepqmc_tpu.gnn.electron_gnn as jeg
import deepqmc_tpu.gnn.update_features as juf
import deepqmc_tpu.wf.cusp as jcusp
import deepqmc_tpu.wf.env as jenv
import deepqmc_tpu.wf.nn_wave_function as jwf
import deepqmc_tpu.wf.omni as jomni
import deepqmc_tpu_torch as dqt
import deepqmc_tpu_torch.gnn.edge_features as tef
import deepqmc_tpu_torch.gnn.electron_gnn as teg
import deepqmc_tpu_torch.gnn.update_features as tuf
import deepqmc_tpu_torch.wf.cusp as tcusp
import deepqmc_tpu_torch.wf.env as tenv
import deepqmc_tpu_torch.wf.nn_wave_function as twf
import deepqmc_tpu_torch.wf.omni as tomni
from deepqmc_tpu import nn as jnn
from deepqmc_tpu.physics import loop_laplacian as jax_loop_laplacian
from deepqmc_tpu.wf import instantiate_ansatz
from deepqmc_tpu_torch import fwdlap as fl
from deepqmc_tpu_torch import nn as tnn
from deepqmc_tpu_torch.convert import state_dict_from_jax
from deepqmc_tpu_torch.presets import build_ansatz

PSI_RTOL, ELOC_RTOL, MODULE_RTOL = 1e-10, 1e-9, 1e-12
TERMS = ('E_kin', 'V_loc', 'V_el', 'lap', 'quantum_force')
JAX = SimpleNamespace(nn=jnn, eg=jeg, uf=juf, ef=jef, env=jenv, cusp=jcusp, omni=jomni, wf=jwf,
                      tanh=jnp.tanh)
PORT = SimpleNamespace(nn=tnn, eg=teg, uf=tuf, ef=tef, env=tenv, cusp=tcusp, omni=tomni,
                       wf=twf, tanh=fl.tanh)
N_DET, N_ENV, DIM = 2, 4, 16


def _dist_diff(P):
    return P.ef.CombinedEdgeFeature(features=[P.ef.DistancePowerEdgeFeature(powers=[1]),
                                              P.ef.DifferenceEdgeFeature()])


def _mlp(P, hidden_layers, bias, last_linear, activation, init):
    return partial(P.nn.MLP, hidden_layers=hidden_layers, bias=bias, last_linear=last_linear,
                   activation=activation, init=init)


def wf_kwargs(P, hamil, case):
    """``NeuralNetworkWaveFunction``'s keyword arguments of ``case`` over the
    classes of the package ``P``."""
    head, ghost, geometry = case == 'head', case == 'ghost', case == 'geometry'
    nuclei = partial(P.eg.NucleiEmbedding, embedding_dim=DIM, atom_type_embedding=head,
                     subnet_type='mlp' if head else 'embed',
                     edge_features=_dist_diff(P) if geometry else None)
    if head:
        electrons = partial(P.eg.ElectronEmbedding, positional_embeddings={'ne': _dist_diff(P)},
                            use_spin=True, project_to_embedding_dim=True)
    else:
        charges = list(hamil.mol.charges) + [0] * ghost
        electrons = partial(
            P.eg.PermutationInvariantEmbedding, charges=jnp.asarray(charges), edge_dim=8,
            edge_features=_dist_diff(P), use_spin=True,
            nuclear_charge_dependence='elementwise-product' if geometry else 'concatenate')
    gnn = partial(
        P.eg.ElectronGNN, n_interactions=2, nuclei_embedding=nuclei, electron_embedding=electrons,
        two_particle_stream_dim=8, self_interaction=True, edge_features=None,
        ghost_coords=[[0.0, 0.0, 1.5]] if ghost else None,
        layer_factory=partial(
            P.eg.ElectronGNNLayer, subnet_factory=lambda *a, **kw: P.nn.Identity(),
            electron_residual=False, nucleus_residual=False, two_particle_residual=False,
            deep_features=False, update_rule='concatenate',
            update_features=[partial(
                P.uf.CombinedNodeAttentionUpdateFeature, num_heads=2,
                mlp_factory=_mlp(P, ['log', 1], True, False, P.tanh, 'ferminet'),
                attention_residual=P.nn.ResidualConnection(normalize=False),
                mlp_residual=P.nn.ResidualConnection(normalize=False),
                elec_to_nuc=not ghost)]),
    )
    n_orb = hamil.n_up + hamil.n_down
    params = {'zetas': (n_orb * N_DET * N_ENV,) if head else (N_DET * N_ENV,)}
    if head:
        params['pis'] = (n_orb * N_DET * N_ENV,)
    if ghost:
        envelope = partial(P.env.ExponentialEnvelopes, isotropic=True, per_shell=False,
                           per_orbital_exponent=True, spin_restricted=False, init_to_ones=True,
                           softplus_zeta=False)
    else:
        envelope = partial(P.env.SimplifiedNucleusDependentEnvelopes,
                           n_envelope_per_nucleus=N_ENV, per_orbital_exponent=head,
                           fixed_pi=geometry)
    cusp = None
    if not geometry:
        cusp = partial(P.cusp.NuclearCuspAsymptotic, alpha=2.0 if head else 1.0,
                       trainable_alpha=head,
                       cusp_function=P.cusp.PsiformerCusp() if head else P.cusp.DeepQMCCusp())
    return dict(
        omni_factory=partial(
            P.omni.OmniNet, embedding_dim=DIM, jastrow_factory=None,
            backflow_factory=partial(P.omni.Backflow, subnet_factory=_mlp(
                P, ['log', 1], False, True, None, 'ferminet')),
            nuclear_gnn_head=(None if ghost else partial(P.omni.NuclearGNNHead,
                                                         one_particle_parameters=params)),
            gnn_factory=gnn),
        envelope=envelope, backflow_op=partial(P.wf.BackflowOp, mult_act=lambda x: x),
        n_determinants=N_DET, full_determinant=True, cusp_electrons=None, cusp_nuclei=cusp,
        backflow_transform='mult', conf_coeff=P.nn.SumPool,
    )


CASES = {'head': 'LiH', 'ghost': 'LiH', 'geometry': 'H2O'}


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    return {path: {k: np.asarray(v) + 0.1 * rng.normal(size=np.shape(v))
                   for k, v in bundle.items()} for path, bundle in params.items()}


@functools.cache
def _jax(case):
    hamil = dqj.MolecularHamiltonian(mol=molecule(dqj, CASES[case]),
                                     laplacian_factory=jax_loop_laplacian)
    ansatz = instantiate_ansatz(
        hamil, lambda h: jwf.NeuralNetworkWaveFunction(h, **wf_kwargs(JAX, h, case)))
    pc = init_sample(hamil, 1, 0)[0]
    params = _noisy(jit_once(ansatz.init)(jax.random.PRNGKey(1), pc), 0)
    r = walkers(hamil, 'init_sample', n=3, seed=4)
    pcs = jax_phys_conf(hamil, r)
    psi = jit_once(jax.vmap(ansatz.apply, (None, 0)))(params, pcs)
    eloc, stats = jit_once(jax.vmap(hamil.local_energy(ansatz.apply), (None, None, 0)))(
        None, params, pcs)
    want = {'E_loc': np.asarray(eloc), **{k: np.asarray(stats[f'hamil/{k}']) for k in TERMS}}
    return params, r, psi, want


def _port(case, params):
    hamil = dqt.MolecularHamiltonian(mol=molecule(dqt, CASES[case]))
    wf = build_ansatz(hamil, wf_kwargs(PORT, hamil, case)).double()
    wf.load_state_dict(state_dict_from_jax(params, wf))
    return hamil, wf


@pytest.mark.parametrize('case', CASES)
def test_psi_matches_jax(case):
    params, r, want, _ = _jax(case)
    hamil, wf = _port(case, params)
    with torch.inference_mode():
        got = wf(torch_phys_conf(hamil, r))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.log.numpy(), np.asarray(want.log), rtol=PSI_RTOL)


@pytest.mark.parametrize('case', CASES)
def test_local_energy_matches_jax(case):
    params, r, _, want = _jax(case)
    hamil, wf = _port(case, params)
    with torch.inference_mode():
        eloc, stats = hamil.local_energy(wf, torch_phys_conf(hamil, r))
    got = {'E_loc': eloc.numpy(), **{k: stats[f'hamil/{k}'].numpy() for k in TERMS}}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=ELOC_RTOL, err_msg=key)


def test_components_are_the_ones_built():
    """Each case builds what it names: the head's parameters and their
    shapes, the nuclear tokens, the ghost, the mask, the envelope."""
    params, *_ = _jax('head')
    _, wf = _port('head', params)
    head = wf.omni.nuclear_gnn_head
    assert sorted(head.glus) == ['pis', 'zetas'] and head.zetas_bias_up.shape == (2, 32)
    assert isinstance(wf.envelope, tenv.SimplifiedNucleusDependentEnvelopes)
    assert wf.cusp_nuclei.nuc_alpha.requires_grad
    params, *_ = _jax('ghost')
    _, wf = _port('ghost', params)
    gnn = wf.omni.gnn
    assert len(gnn.ghost_coords) == 1 and wf.omni.nuclear_gnn_head is None
    assert gnn.nuclei_embedding.subnet.embeddings.shape == (3, DIM)  # index tokens, ghost included
    assert not gnn.layers[0].update_features[0].elec_to_nuc
    assert 'nuc_alpha' not in dict(wf.named_parameters())


def _jax_module(build, pc):
    model = jnn.transform(build)
    params = _noisy(model.init(jax.random.PRNGKey(2), pc), 1)
    return params, model.apply(params, pc)


@pytest.mark.parametrize('subnet_type, atom_type_embedding',
                         [('mlp', True), ('mlp', False), ('embed', True), ('embed', False)])
def test_nuclei_embedding_matches_jax(subnet_type, atom_type_embedding):
    """The geometry-free nuclear embeddings of H2O: a token per nucleus
    (charge or index) through an MLP or a table (atom types or indices)."""
    hamil_j = dqj.MolecularHamiltonian(mol=molecule(dqj, 'H2O'))
    kw = dict(embedding_dim=8, atom_type_embedding=atom_type_embedding,
              subnet_type=subnet_type, edge_features=None)
    args = (hamil_j.n_up, hamil_j.n_down, hamil_j.mol.charges, hamil_j.mol.n_atom_types)
    pc = jax_phys_conf(hamil_j, walkers(hamil_j, 'init_sample', n=1))
    params, want = _jax_module(
        lambda pc: jeg.NucleiEmbedding(*args, **kw)(jax.tree_util.tree_map(lambda x: x[0], pc)),
        pc)
    with tnn.init_generator(torch.Generator().manual_seed(0)):
        emb = teg.NucleiEmbedding(*args[:2], list(hamil_j.mol.charges), args[3], **kw).double()
    emb.load_state_dict(state_dict_from_jax(params, emb))
    R = torch.as_tensor(np.asarray(hamil_j.mol.coords))[None]
    got = emb(R)
    assert got.shape == (1, 3, 8)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want), rtol=MODULE_RTOL)


@pytest.mark.parametrize('dependence', ['concatenate', 'elementwise-product'])
def test_permutation_invariant_embedding_matches_jax(dependence):
    """H2O's electron embeddings from the electron-nucleus edges and the atom
    types, both charge dependences; invariant under swapping the two H."""
    hamil_j = dqj.MolecularHamiltonian(mol=molecule(dqj, 'H2O'))
    n_el = hamil_j.n_up + hamil_j.n_down
    args = (hamil_j.n_nuc, hamil_j.n_up, hamil_j.n_down, 8, 1, jnp.zeros(n_el, jnp.int32),
            hamil_j.mol.charges)

    def kw(P):
        return dict(edge_dim=6, edge_features=_dist_diff(P), use_spin=True,
                    nuclear_charge_dependence=dependence)

    r = walkers(hamil_j, 'init_sample', n=1, seed=5)
    pc = jax.tree_util.tree_map(lambda x: x[0], jax_phys_conf(hamil_j, r))
    params, want = _jax_module(
        lambda pc: jeg.PermutationInvariantEmbedding(*args, **kw(JAX))(pc, None), pc)
    with tnn.init_generator(torch.Generator().manual_seed(0)):
        emb = teg.PermutationInvariantEmbedding(*args[:5], args[5], list(args[6]),
                                                **kw(PORT)).double()
    emb.load_state_dict(state_dict_from_jax(params, emb))
    R = torch.as_tensor(np.asarray(hamil_j.mol.coords))[None]
    got = emb(torch.as_tensor(r), R)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want), rtol=MODULE_RTOL)
    swapped = emb(torch.as_tensor(r), R[:, [0, 2, 1]])
    np.testing.assert_allclose(swapped.detach().numpy(), got.detach().numpy(), rtol=1e-12)


@pytest.mark.parametrize('positional', [None, ('ne', 'same', 'anti')],
                         ids=['embed-table', 'ne-same-anti'])
def test_electron_embedding_matches_jax(positional):
    """H2O's electron embeddings without positional edges (the table of
    electron types) and from several positional edge types ('same' and
    'anti' flattened as the JAX package flattens them), with the spin,
    projected to the embedding width."""
    hamil_j = dqj.MolecularHamiltonian(mol=molecule(dqj, 'H2O'))
    n_el = hamil_j.n_up + hamil_j.n_down
    args = (hamil_j.n_nuc, hamil_j.n_up, hamil_j.n_down, 8, 1, jnp.zeros(n_el, jnp.int32))

    def kw(P):
        return dict(positional_embeddings=positional and {t: _dist_diff(P) for t in positional},
                    use_spin=True, project_to_embedding_dim=True)

    r = walkers(hamil_j, 'init_sample', n=1, seed=6)
    pc = jax.tree_util.tree_map(lambda x: x[0], jax_phys_conf(hamil_j, r))
    params, want = _jax_module(
        lambda pc: jeg.ElectronEmbedding(*args, **kw(JAX))(pc, None), pc)
    with tnn.init_generator(torch.Generator().manual_seed(0)):
        emb = teg.ElectronEmbedding(*args[:5], np.zeros(n_el, np.int64), **kw(PORT)).double()
    emb.load_state_dict(state_dict_from_jax(params, emb))
    R = torch.as_tensor(np.asarray(hamil_j.mol.coords))[None]
    got = emb(torch.as_tensor(r), R)
    assert got.shape == (1, n_el, 8)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want), rtol=MODULE_RTOL)
