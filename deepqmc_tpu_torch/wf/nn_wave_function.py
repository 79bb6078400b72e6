"""The neural-network wave function (counterpart of
``deepqmc_tpu/wf/nn_wave_function.py``): envelopes with backflow give flat
det-major orbitals per spin; full determinants over the row concatenation
(``[n, D*n]`` per spin), or one determinant per spin (``[n_spin, D*n_spin]``);
an exp-normalised mix over determinants by ``conf_coeff``; plus the cusps
and the Jastrow factor.

The classes take the JAX classes' arguments; their factories are called as
the JAX package calls them, with the widths the JAX package learns at the
first call added in front (``conf_coeff(n_det, 1)``, ``cusp_electrons(n_up,
n_down)``) and ``nuc_params_from_head`` for the envelope."""

from typing import Optional

import torch

from .. import fwdlap as fl
from .. import nn
from ..types import PhysicalConfiguration, Psi

__all__ = ['BackflowOp', 'NeuralNetworkWaveFunction']


class BackflowOp(nn.Module):
    """Multiplicative (``xs * mult_act(f)``) and additive backflow on the flat
    orbitals ``[B, n_s, n_det * n_orb]``; the additive term is scaled by the
    orbitals' norm (``with_envelope``) and cut off near the nuclei."""

    def __init__(self, mult_act=None, add_act=None, with_envelope=True,
                 name: Optional[str] = None):
        super().__init__()
        self.mult_act = mult_act or (lambda x: 1 + 2 * fl.tanh(x / 4))
        self.add_act = add_act or (lambda x: 0.1 * fl.tanh(x / 4))
        self.with_envelope = with_envelope

    def forward(self, xs, fs_mult, fs_add, dists_nuc):
        envel = None
        if fs_add is not None and self.with_envelope:
            envel = fl.sqrt((xs * xs).sum(-1, keepdim=True))
        if fs_mult is not None:
            xs = xs * self.mult_act(fs_mult)
        if fs_add is not None:
            R = fl.amin(dists_nuc, -1) / 0.5
            near = (fl.primal(R) < 1).to(fl.primal(R).dtype)  # a constant selector
            cutoff = R**2 * (3 * R**2 - 8 * R + 6) * near + (1 - near)
            add = self.add_act(fs_add)
            xs = xs + cutoff[..., None] * (add if envel is None else envel * add)
        return xs


class NeuralNetworkWaveFunction(nn.Module):
    """``phys_conf -> Psi(sign [B], log [B])``; ``phys_conf.r`` may be an FL,
    in which case ``log`` is an FL carrying its gradient and Laplacian."""

    def __init__(self, hamil, *, omni_factory, envelope, backflow_op, n_determinants,
                 full_determinant, cusp_electrons, cusp_nuclei, backflow_transform, conf_coeff,
                 name: Optional[str] = None):
        super().__init__()
        if backflow_transform not in ('mult', 'add', 'both'):
            raise ValueError(f"backflow_transform {backflow_transform!r}: want 'mult', 'add' or "
                             "'both'")
        self.n_up, self.n_down = hamil.n_up, hamil.n_down
        self.n_det = n_determinants
        self.full_determinant = full_determinant
        self.backflow_transform = backflow_transform
        n = self.n_up + self.n_down
        n_orb = (n, n) if full_determinant else (self.n_up, self.n_down)
        n_backflows = 2 if backflow_transform == 'both' else 1
        self.omni = omni_factory(hamil, *n_orb, n_determinants, n_backflows) if omni_factory \
            else None
        head = self.omni is not None and self.omni.nuclear_gnn_head is not None
        self.envelope = envelope(hamil, n_determinants, nuc_params_from_head=head)
        self.conf_coeff = conf_coeff(n_determinants, 1, name='conf_coeff')
        self.cusp_electrons = cusp_electrons(self.n_up, self.n_down) if cusp_electrons else None
        self.cusp_nuclei = cusp_nuclei(hamil.mol.charges) if cusp_nuclei else None
        self.backflow_op = backflow_op() if backflow_op else None
        if self.omni is not None and self.omni.backflow is not None and self.backflow_op is None:
            raise ValueError('backflow factors need a backflow_op')

    def _backflow(self, xs, fs, dists_nuc):
        """The orbitals ``xs`` of one spin with the backflow factors ``fs``
        ``[B, n_backflows, n_s, D*n_orb]``."""
        fs_mult = fs[..., 0, :, :] if self.backflow_transform != 'add' else None
        fs_add = fs[..., -1, :, :] if self.backflow_transform != 'mult' else None
        return self.backflow_op(xs, fs_mult, fs_add, dists_nuc)

    def _determinant_mix(self, orb_up, orb_down):
        """Slater determinants -> exp-normalised mix over determinants."""
        if self.full_determinant:
            sign, logdet = fl.slogdet_flat_rows(orb_up, orb_down, self.n_det)
        else:
            sign_up, logdet_up = fl.slogdet_flat(orb_up, self.n_det)
            sign_down, logdet_down = fl.slogdet_flat(orb_down, self.n_det)
            sign, logdet = sign_up * sign_down, logdet_up + logdet_down
        # the shift is a common factor of the (linear) mix, so it cancels
        # exactly in log|psi| and its derivatives: a constant here
        shift = fl.primal(logdet).amax(-1, keepdim=True)
        shift = torch.where(torch.isinf(shift), torch.zeros_like(shift), shift)
        psi = self.conf_coeff(sign * fl.exp(logdet - shift)).squeeze(-1)
        return torch.sign(fl.primal(psi)), fl.log(fl.abs(psi)) + shift.squeeze(-1)

    def _spin_orbitals(self, phys_conf: PhysicalConfiguration):
        """Per-spin flat orbital matrices ``[B, n_spin, n_det * n_orb]``; FLs
        when ``phys_conf.r`` is one."""
        return self._orbitals(phys_conf)[:2]

    def _orbitals(self, phys_conf: PhysicalConfiguration):
        """The orbitals of each spin, the Jastrow term (or None) and the
        electron-nucleus distances (or None where nothing reads them), from
        one pass of the GNN.  Without full determinants each spin keeps its
        own orbitals' columns of the envelopes (orbital o of determinant d at
        column d * n + o)."""
        r, R = phys_conf.r, phys_conf.R
        jastrow, fs, nuc_params = self.omni(r, R) if self.omni is not None else (None,) * 3
        # per-walker nuclei [B, n_nuc, 3] line up with r[..., :, None, :] as [B, 1, n_nuc, 3]
        R_rows = R[:, None] if R.dim() == 3 else R
        orb_up, orb_down = self.envelope(r, R_rows, nuc_params)
        n_up = self.n_up
        if not self.full_determinant:
            orb_up = orb_up.unflatten(-1, (self.n_det, -1))[..., :n_up].flatten(-2)
            orb_down = orb_down.unflatten(-1, (self.n_det, -1))[..., n_up:].flatten(-2)
        dists_nuc = None
        if self.cusp_nuclei is not None or (fs is not None and self.backflow_transform != 'mult'):
            d = r[..., :, None, :] - R_rows  # [B, n_el, n_nuc, 3]
            dists_nuc = fl.sqrt((d * d).sum(-1))
        if fs is not None:
            rows = ((None, None) if dists_nuc is None
                    else (dists_nuc[..., :n_up, :], dists_nuc[..., n_up:, :]))
            orb_up = self._backflow(orb_up, fs[0], rows[0])
            orb_down = self._backflow(orb_down, fs[1], rows[1])
        return orb_up, orb_down, jastrow, dists_nuc

    def forward(self, phys_conf: PhysicalConfiguration, return_mos: bool = False):
        """``Psi``, or with ``return_mos`` the orbitals of each spin unpacked
        from the flat det-major layout into ``[B, n_det, n_spin, n_orb]``
        (the pretraining targets' layout, as the JAX package's cold path)."""
        orb_up, orb_down, jastrow, dists_nuc = self._orbitals(phys_conf)
        if return_mos:
            return tuple(o.unflatten(-1, (self.n_det, -1)).movedim(-2, -3)
                         for o in (orb_up, orb_down))
        sign, log_psi = self._determinant_mix(orb_up, orb_down)
        if self.cusp_electrons is not None:
            log_psi = log_psi + self.cusp_electrons(phys_conf.r)
        if self.cusp_nuclei is not None:
            log_psi = log_psi + self.cusp_nuclei(dists_nuc)
        if jastrow is not None:
            log_psi = log_psi + jastrow
        return Psi(sign, log_psi)
