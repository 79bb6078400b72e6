"""Hellmann-Feynman force estimators (counterpart of ``deepqmc_tpu/force.py``).

The five estimators of the JAX package: the bare Coulomb force, the
antithetic-coordinate zero-variance ``ac_zv`` and zero-variance zero-bias
``ac_zvzb`` [10.1063/5.0052266], and their Q-function counterparts ``ac_zvq``
and ``ac_zvzbq`` [10.1063/1.1621615].  Each factory returns a function of a
batch of one molecule's walkers (``phys_conf`` with ``R`` ``[M, 3]`` and ``r``
``[B, n, 3]``) that gives the force on every nucleus of every walker, ``[B, M,
3]``; the zero-bias ones also take each walker's local energy and the mean
energy ``[B]``.

**The zero-variance term of ac_zv.**  The JAX package takes the local energy
of ``directional_grad_wf``, the wave function d psi = psi t along each of the
3M nuclear coordinates, with ``t = d log|psi| / dR`` along it and ``log|d psi|
= log|psi| + log|t|``.  The potential does not depend on psi, so with
``J = grad_r log|psi|`` and ``(t, grad_r t, lap_r t)`` that algebra gives

    E_loc[d psi] - E_loc[psi] = -(J . grad_r t + lap_r t / 2) / t,

and the estimator's term ``(E_loc[d psi] - E_loc) t`` is ``-(J . grad_r t +
lap_r t / 2)``, the nuclear derivative of the kinetic local energy.  The port
forms it so, without the division by t, which is exact in exact arithmetic
and is better conditioned where |t| is near 0; ac_zv therefore needs no local
energy of its own.  The three tangents are those of the forward Laplacian's
(log|psi|, J, lap log|psi|) along a nuclear direction: one forward-mode pass
(``torch.func.jvp`` over ``R``), vmapped over a chunk of the 3M directions as
the JAX package vmaps them, the chunks in sequence.  ``direction_chunk`` is
the largest divisor of 3M at most the chunk (0: all at once); its default
reads ``DEEPQMC_TPU_FORCE_DIRECTION_CHUNK`` (6), as the JAX package does.

**The tangent pass** (:func:`log_psi_tangents`):

- it refuses to run under ``torch.inference_mode()``, where forward-mode
  tangents are dropped, and clones its inputs (which the evaluation loop
  makes under inference mode) before it makes them dual; it runs under
  ``torch.no_grad()``;
- it runs the forward Laplacian with the kernels' plain PyTorch versions on
  any device (``fwdlap.use_plain_cores``): the CUDA
  kernels of the attention core, the log-determinant traces and the PsiFormer
  block are ``ctypes`` launches that carry no tangent, and their wrappers
  raise on an operand that carries one (``ops._cuda.refuse_tangents``);
- the evaluation steps around the monitors, whose local energies feed the
  zero-bias estimators, still run the kernels.

The JAX package's ``ac_zv`` does not reach its attention kernel either:
``jax.jvp`` keeps the name ``_mha_core_flat_{H}`` of the attention core's
jit, but the jvp'd call takes the tangents as extra operands (4 to 6 inputs,
2 outputs), so the forward-Laplacian interpreter's fused rule, which asks for
three operands (``deepqmc_tpu/fwdlap.py`` ``_interpret``), does not match and
the core runs through the generic per-primitive rules.  Neither package has a
tangent rule for its kernels.

A Hamiltonian with effective core potentials raises: the JAX package's
estimators are not implemented for ECPs (it passes no key to the nonlocal
quadrature there).
"""

import torch

from . import fwdlap as fl
from .physics import coulomb_force
from .utils import chunk_size, matmul_precision

__all__ = [
    'Q', 'evaluate_hf_force_ac_zv', 'evaluate_hf_force_ac_zvq', 'evaluate_hf_force_ac_zvzb',
    'evaluate_hf_force_ac_zvzbq', 'evaluate_hf_force_bare', 'grad_nuc_log_psi',
    'log_psi_tangents',
]


def _charges(hamil, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(hamil.mol.charges, dtype=like.dtype, device=like.device)


def _refuse_ecp(hamil):
    if hamil.ecp is not None:
        raise ValueError('the force estimators are not implemented for effective core '
                         'potentials (the JAX package has none either)')


def _over_directions(fn, R, chunk):
    """``fn`` vmapped over the unit directions of the 3M nuclear coordinates
    in sequential chunks; every output gets the direction axis in front."""
    n_coord = R.numel()
    size = chunk_size(n_coord, chunk, 'DEEPQMC_TPU_FORCE_DIRECTION_CHUNK', default=6)
    eye = torch.eye(n_coord, dtype=R.dtype, device=R.device).view(n_coord, *R.shape)
    parts = [torch.func.vmap(fn)(eye[i:i + size]) for i in range(0, n_coord, size)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _cloned(phys_conf):
    """The walkers as ordinary tensors: a clone made outside inference mode of
    tensors that may have been made inside it."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError('the force estimators take nuclear tangents by forward-mode '
                           'autodiff, which torch.inference_mode() drops: call them outside it')
    return phys_conf.replace(R=phys_conf.R.clone(), r=phys_conf.r.clone(),
                             mol_idx=phys_conf.mol_idx.clone())


def log_psi_tangents(wf, phys_conf, direction_chunk=None):
    """The forward Laplacian of log|psi| and its tangents along the nuclear
    coordinates: ``(J [B, 3n], (t, grad_r t, lap_r t))`` with ``t``
    ``[3M, B]`` = d log|psi| / dR_c, ``grad_r t`` ``[3M, B, 3n]`` and
    ``lap_r t`` ``[3M, B]`` for each coordinate c of ``R`` in row-major order.
    Runs the kernels' plain versions (see the module's docstring)."""
    pc = _cloned(phys_conf)

    def log_psi_fl(R):
        # the Jacobian levers and the 'highest' pin of fwdlap.forward_laplacian
        with fl.use_plain_cores(), fl.jac_levers(), matmul_precision('highest'):
            out = wf(pc.replace(R=R, r=fl.FL.seed(pc.r))).log
            return out.x, out.jac, out.lap

    def tangents(e):
        (_, jac, _), tangent = torch.func.jvp(log_psi_fl, (pc.R,), (e,))
        if any(x is None for x in tangent):
            raise RuntimeError('the tangent pass lost a tangent')
        return jac, *tangent

    with torch.no_grad():
        jac, t, jac_t, lap_t = _over_directions(tangents, pc.R, direction_chunk)
    return jac[0], (t, jac_t, lap_t)


def grad_nuc_log_psi(wf, phys_conf, direction_chunk=None) -> torch.Tensor:
    """``d log|psi| / dR`` of every walker, ``[B, M, 3]``: forward-mode tangents
    of the plain forward along the 3M nuclear coordinates."""
    pc = _cloned(phys_conf)
    with torch.no_grad():
        (t,) = _over_directions(
            lambda e: (torch.func.jvp(lambda R: wf(pc.replace(R=R)).log, (pc.R,), (e,))[1],),
            pc.R, direction_chunk)
    return t.T.reshape(-1, *pc.R.shape)


def Q(r: torch.Tensor, R: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The Q function of [Assaraf & Caffarel, 10.1063/1.1621615]: ``sum_i c_I
    (r_i - R_I) / |r_i - R_I|``, ``[..., M, 3]`` from ``r`` ``[..., n, 3]``."""
    dists = r[..., None, :, :] - R[:, None, :]
    return (c[:, None, None] * dists / torch.linalg.vector_norm(dists, dim=-1,
                                                                keepdim=True)).sum(-2)


def evaluate_hf_force_bare(hamil):
    """Bare (high-variance) Coulomb estimator of the HF force."""

    def bare(phys_conf) -> torch.Tensor:
        R, r = phys_conf.R, phys_conf.r
        charges_nuc = _charges(hamil, R)
        charges_elec = -torch.ones(r.shape[-2], dtype=r.dtype, device=r.device)
        force_nuc = coulomb_force(R, R, charges_nuc, charges_nuc, True)
        return force_nuc + coulomb_force(R.expand(len(r), *R.shape), r, charges_nuc,
                                         charges_elec)

    return bare


def _ac_zv_and_grad(hamil, wf, direction_chunk):
    """``phys_conf -> (ac_zv force, d log|psi| / dR)``, both ``[B, M, 3]``, from
    one tangent pass."""
    _refuse_ecp(hamil)
    bare = evaluate_hf_force_bare(hamil)

    def zv(phys_conf):
        J, (t, jac_t, lap_t) = log_psi_tangents(wf, phys_conf, direction_chunk)
        # (E_loc[d psi] - E_loc) t = -(J . grad_r t + lap_r t / 2), [3M, B]
        shape = (-1, *phys_conf.R.shape)
        kinetic = (J * jac_t).sum(-1) + lap_t / 2
        return bare(phys_conf) + kinetic.T.reshape(shape), t.T.reshape(shape)

    return zv


def evaluate_hf_force_ac_zv(hamil, wf, *, direction_chunk=None):
    """Antithetic-coordinate zero-variance estimator [10.1063/5.0052266]."""
    zv_and_grad = _ac_zv_and_grad(hamil, wf, direction_chunk)
    return lambda phys_conf: zv_and_grad(phys_conf)[0]


def evaluate_hf_force_ac_zvq(hamil, wf):
    """Q-function zero-variance estimator [10.1063/1.1621615]: the contraction
    sum_i grad_{r_i} log|psi| . grad_{r_i} Q as one jvp of Q along
    grad_r log|psi|, which an autograd backward of the plain forward gives."""
    _refuse_ecp(hamil)

    def zvq(phys_conf):
        pc = _cloned(phys_conf)
        charges = _charges(hamil, pc.R)
        with torch.enable_grad():
            r = pc.r.requires_grad_()
            (grad_log_psi,) = torch.autograd.grad(wf(pc.replace(r=r)).log.sum(), r)
        with torch.no_grad():
            zv_term = torch.func.jvp(lambda r: Q(r, pc.R, charges), (pc.r,), (grad_log_psi,))[1]
            return zv_term + coulomb_force(pc.R, pc.R, charges, charges, True)

    return zvq


def _zero_bias(zv, g, local_energy, energy):
    """The ZB term ``-2 (E_loc - E) g`` on a ZV estimate ``zv`` ``[B, M, 3]``."""
    return zv - 2 * (local_energy - energy)[:, None, None] * g


def evaluate_hf_force_ac_zvzb(hamil, wf, *, direction_chunk=None):
    """Zero-variance zero-bias estimator [10.1063/5.0052266]; the ZB term's
    d log|psi| / dR comes from the ac_zv term's tangent pass."""
    zv_and_grad = _ac_zv_and_grad(hamil, wf, direction_chunk)

    def zvzb(phys_conf, local_energy, energy):
        zv, grad = zv_and_grad(phys_conf)
        return _zero_bias(zv, grad, local_energy, energy)

    return zvzb


def evaluate_hf_force_ac_zvzbq(hamil, wf):
    """Q-function zero-variance zero-bias estimator [10.1063/1.1621615]."""
    zvq = evaluate_hf_force_ac_zvq(hamil, wf)

    def zvzbq(phys_conf, local_energy, energy):
        q = Q(phys_conf.r, phys_conf.R, _charges(hamil, phys_conf.R))
        return _zero_bias(zvq(phys_conf), q, local_energy, energy)

    return zvzbq
