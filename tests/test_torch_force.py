"""The port's Hellmann-Feynman force estimators against the JAX package.

The five estimators of ``deepqmc_tpu_torch.force`` and ``grad_nuc_log_psi``
against ``deepqmc_tpu.force`` at float64 on the same parameters and walkers:
the small PsiFormer cut to one layer, H2 here and LiH in
``test_torch_force_lih.py`` (which runs this file's tests on its own
fixture), 2 walkers.  Relative
tolerance 1e-8 of each estimator's largest entry: the zero-variance terms
are derivatives of the forward Laplacian, long chains of float64 products
that agree to about 1e-13 here, and the port forms ac_zv's term without the
JAX package's division by t (``force.py``'s docstring), which moves nothing
at these walkers (|t| is far from 0).  Then the JAX tests' analytic cases on
the port (the bare force by hand, the ac_zv term against the local energy of
JAX's ``directional_grad_wf``, the Q contraction against the Jacobian), the
direction chunks, the tangent pass's refusal of inference mode, the kernel
wrappers' refusal of a dual operand, and the refusal of ECPs.
"""

import jax
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad
from torch_parity import assert_close, jax_model, jax_phys_conf, torch_model, torch_phys_conf
from torch_parity import walkers as draw_walkers

from deepqmc_tpu import force as jforce
from deepqmc_tpu_torch import MolecularHamiltonian, Molecule
from deepqmc_tpu_torch import force
from deepqmc_tpu_torch.ops import fl_attention, fl_block, fl_slogdet
from deepqmc_tpu_torch.physics import coulomb_force

RTOL = 1e-8
ESTIMATORS = ('bare', 'ac_zv', 'ac_zvq', 'ac_zvzb', 'ac_zvzbq')
WITH_ENERGY = ('ac_zvzb', 'ac_zvzbq')


def jax_forces(hamil_j, ansatz, params, pc):
    """E_loc, the five estimators and grad_nuc_log_psi of the JAX package over
    the walkers ``pc`` (one jitted program), as numpy arrays."""

    def run(params, pc):
        e_loc, _ = jax.vmap(hamil_j.local_energy(ansatz.apply), (None, None, 0))(None, params, pc)
        energy = jax.numpy.full_like(e_loc, e_loc.mean())
        out = {'e_loc': e_loc, 'energy': energy}
        for kind in ESTIMATORS:
            build = getattr(jforce, f'evaluate_hf_force_{kind}')
            fn = build(hamil_j) if kind == 'bare' else build(hamil_j, ansatz.apply)
            if kind in WITH_ENERGY:
                out[kind] = jax.vmap(fn, (None, 0, 0, 0))(params, pc, e_loc, energy)
            else:
                out[kind] = jax.vmap(fn, (None, 0))(params, pc)
        out['grad'] = jax.vmap(lambda pc: jforce.grad_nuc_log_psi(ansatz.apply, params, pc))(pc)
        return out

    return {k: np.asarray(v) for k, v in jax.jit(run)(params, pc).items()}


def make_case(mol):
    hamil_j, ansatz, params = jax_model(mol, seed=1, n_interactions=1)
    r = draw_walkers(hamil_j, 'init_sample', n=2, seed=3)
    want = jax_forces(hamil_j, ansatz, params, jax_phys_conf(hamil_j, r))
    hamil, wf = torch_model(mol, params, overrides={'n_interactions': 1})
    return dict(hamil=hamil, wf=wf, pc=torch_phys_conf(hamil, r),
                e_loc=torch.tensor(want['e_loc']), energy=torch.tensor(want['energy']),
                want=want, hamil_j=hamil_j, ansatz=ansatz, params=params, r=r)


@pytest.fixture(scope='module')
def case():
    return make_case('H2')


def _estimate(case, kind, **kwargs):
    build = getattr(force, f'evaluate_hf_force_{kind}')
    fn = build(case['hamil']) if kind == 'bare' else build(case['hamil'], case['wf'], **kwargs)
    if kind in WITH_ENERGY:
        return fn(case['pc'], case['e_loc'], case['energy'])
    return fn(case['pc'])


@pytest.mark.parametrize('kind', ESTIMATORS)
def test_estimator_matches_jax(case, kind):
    assert_close(_estimate(case, kind), case['want'][kind], RTOL, kind)


def test_grad_nuc_log_psi_matches_jax(case):
    assert_close(force.grad_nuc_log_psi(case['wf'], case['pc']), case['want']['grad'], RTOL)


@pytest.mark.parametrize('chunk', [0, 1, 4])
def test_direction_chunks_change_nothing(case, chunk):
    """Chunks of 1, 3 (the largest divisor of 3M at most 4 for M = 2) or all
    3M directions give the default's ac_zv to rounding."""
    got = force.evaluate_hf_force_ac_zv(case['hamil'], case['wf'], direction_chunk=chunk)
    assert_close(got(case['pc']), case['want']['ac_zv'], RTOL)


def test_ac_zv_term_is_the_local_energy_of_the_derivative(case):
    """The port's closed form of (E_loc[d psi] - E_loc) t, -(J . grad t +
    lap t / 2), against the JAX package's local energy of
    ``directional_grad_wf`` along the first nuclear coordinate, minus E_loc,
    times t."""
    hamil_j, ansatz, params = case['hamil_j'], case['ansatz'], case['params']
    pc = jax_phys_conf(hamil_j, case['r'])
    e = np.zeros(np.shape(hamil_j.mol.coords))
    e[0, 0] = 1.0
    dwf = jforce.directional_grad_wf(ansatz.apply, jax.numpy.asarray(e))
    e_dpsi, _ = jax.jit(jax.vmap(hamil_j.local_energy(dwf), (None, None, 0)))(None, params, pc)
    grad = case['want']['grad'][:, 0, 0]
    want = (np.asarray(e_dpsi) - np.asarray(case['e_loc'])) * grad
    J, (t, jac_t, lap_t) = force.log_psi_tangents(case['wf'], case['pc'])
    assert_close(t[0], grad, RTOL, 't')
    assert_close(-((J * jac_t[0]).sum(-1) + lap_t[0] / 2), want, RTOL, 'term')


def test_bare_force_by_hand():
    hamil = MolecularHamiltonian(mol=Molecule.from_name('H2'))
    R = torch.as_tensor(hamil.mol.coords)
    r = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 2, 3)))
    from deepqmc_tpu_torch.types import PhysicalConfiguration

    f = force.evaluate_hf_force_bare(hamil)(PhysicalConfiguration(R, r, torch.zeros(3)))
    assert f.shape == (3, 2, 3)
    for b in range(3):
        d01 = R[0] - R[1]
        f_nn = d01 / d01.norm() ** 3
        d_e = R[0] - r[b]
        f_en = -(d_e / d_e.norm(dim=-1, keepdim=True) ** 3).sum(0)
        torch.testing.assert_close(f[b, 0], f_nn + f_en, rtol=1e-12, atol=0)


def test_coulomb_force_matches_jax():
    from deepqmc_tpu.physics import coulomb_force as jax_coulomb_force

    rng = np.random.default_rng(1)
    R, r = rng.normal(size=(3, 3)), rng.normal(size=(5, 3))
    c1, c2 = np.array([8.0, 1.0, 1.0]), -np.ones(5)
    for a, b, ca, cb, self_int in ((R, R, c1, c1, True), (R, r, c1, c2, False)):
        got = coulomb_force(*map(torch.as_tensor, (a, b, ca, cb)), self_int)
        assert_close(got, jax_coulomb_force(a, b, ca, cb, self_int), 1e-12)


def test_zvq_contraction_matches_jacobian(case):
    """The jvp of Q along grad_r log|psi| against the explicit contraction of
    the Jacobian of Q with grad_r log|psi|."""
    pc, wf = case['pc'], case['wf']
    charges = torch.as_tensor(case['hamil'].mol.charges, dtype=torch.float64)
    r = pc.r.clone().requires_grad_()
    (grad_log_psi,) = torch.autograd.grad(wf(pc.replace(r=r)).log.sum(), r)
    for b in range(len(r)):
        jac = torch.func.jacfwd(lambda x: force.Q(x, pc.R, charges))(pc.r[b])  # [M, 3, n, 3]
        want = (jac * grad_log_psi[b]).sum((-1, -2)) + coulomb_force(pc.R, pc.R, charges,
                                                                    charges, True)
        torch.testing.assert_close(_estimate(case, 'ac_zvq')[b], want, rtol=1e-10, atol=1e-12)


def test_tangent_pass_refuses_inference_mode(case):
    with torch.inference_mode(), pytest.raises(RuntimeError, match='inference_mode'):
        force.log_psi_tangents(case['wf'], case['pc'])


def test_tangent_pass_on_inference_tensors(case):
    """Walkers made under inference mode (as the evaluation loop makes them)
    give the tangents of ordinary ones: the pass clones them outside it."""
    with torch.inference_mode():
        pc = case['pc'].replace(R=case['pc'].R.clone(), r=case['pc'].r.clone())
    assert pc.r.is_inference()
    _, (t, _, lap_t) = force.log_psi_tangents(case['wf'], pc)
    assert_close(t.T.reshape(case['want']['grad'].shape), case['want']['grad'], RTOL)
    assert lap_t.abs().max() > 0


def _slogdet_launch(inv, ju, jd):
    return fl_slogdet._launch(fl_slogdet.slogdet_traces, fl_slogdet.FLAT,
                              'fl_slogdet_traces_launch', inv, (ju, jd), None, ju.shape[1],
                              ju.shape[2], jd.shape[2], None)


def _block_launch(*operands):
    return fl_block._launch(*operands, 2)


@pytest.mark.parametrize('how', ['forward_ad', 'func_jvp'])
@pytest.mark.parametrize('launch, shapes', [
    (fl_attention._launch, [(1, 2, 1, 4)] * 3 + [(1, 3, 2, 1, 4)] * 3 + [(1, 2, 1, 4)] * 3),
    (_block_launch, [(1, 2, 4), (1, 3, 2, 4), (1, 2, 4)] + [(4, 4)] * 5 + [(4,), (4, 4), (4,)]),
    (_slogdet_launch, [(1, 1, 2, 2), (1, 3, 1, 2), (1, 3, 1, 2)]),
], ids=['fl_attention', 'fl_block', 'fl_slogdet'])
def test_kernel_wrappers_refuse_a_dual_operand(how, launch, shapes):
    """The launch of kernels 1, 5 and 2 raises on an operand that carries a
    forward-mode tangent (made by ``forward_ad`` or inside ``torch.func.jvp``)
    before it touches the card: a kernel would drop the tangent silently."""
    rest = [torch.zeros(s) for s in shapes[1:]]
    first = torch.zeros(shapes[0])
    with pytest.raises(RuntimeError, match='tangent'):
        if how == 'forward_ad':
            with forward_ad.dual_level():
                launch(forward_ad.make_dual(first, torch.ones_like(first)), *rest)
        else:
            torch.func.jvp(lambda x: launch(x, *rest), (first,), (torch.ones_like(first),))


def test_ecp_refused():
    hamil = MolecularHamiltonian(mol=Molecule.from_name('LiH'), ecp_type='ccECP')
    assert hamil.ecp is not None
    for kind in ESTIMATORS[1:]:
        with pytest.raises(ValueError, match='effective core potentials'):
            getattr(force, f'evaluate_hf_force_{kind}')(hamil, None)
