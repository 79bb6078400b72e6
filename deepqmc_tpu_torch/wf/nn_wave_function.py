"""The neural-network wave function (counterpart of
``deepqmc_tpu/wf/nn_wave_function.py``): envelopes times backflow give flat
det-major orbitals per spin; full determinants over the row concatenation
(``[n, D*n]`` per spin), or one determinant per spin (``[n_spin, D*n_spin]``);
an exp-normalised mix over determinants by ``conf_coeff`` (``SumPool`` or a
trainable linear layer); plus the electronic cusp and the Jastrow factor."""

import torch

from .. import fwdlap as fl
from .. import nn
from ..types import PhysicalConfiguration, Psi

__all__ = ['NeuralNetworkWaveFunction']


class NeuralNetworkWaveFunction(nn.Module):
    """``phys_conf -> Psi(sign [B], log [B])``; ``phys_conf.r`` may be an FL,
    in which case ``log`` is an FL carrying its gradient and Laplacian."""

    def __init__(self, hamil, *, n_determinants, omni, envelope, cusp_electrons,
                 full_determinant=True, conf_coeff=None):
        super().__init__('neural_network_wave_function')
        self.n_up = hamil.n_up
        self.n_det = n_determinants
        self.full_determinant = full_determinant
        self.omni = omni
        self.envelope = envelope
        self.cusp_electrons = cusp_electrons
        self.conf_coeff = conf_coeff if conf_coeff is not None else nn.SumPool()

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
        """Per-spin flat orbital matrices ``[B, n_spin, n_det * n_orb]``
        (envelope times backflow); FLs when ``phys_conf.r`` is one."""
        return self._orbitals_and_jastrow(phys_conf)[:2]

    def _orbitals_and_jastrow(self, phys_conf: PhysicalConfiguration):
        """The orbitals of each spin and the Jastrow term (or None), from one
        pass of the GNN.  Without full determinants each spin keeps its own
        orbitals' columns of the envelopes (orbital o of determinant d at
        column d * n + o)."""
        r, R = phys_conf.r, phys_conf.R
        jastrow, (fs_up, fs_down) = self.omni(r, R)
        env_up, env_down = self.envelope(r, R)
        if not self.full_determinant:
            n_up = self.n_up
            env_up = env_up.unflatten(-1, (self.n_det, -1))[..., :n_up].flatten(-2)
            env_down = env_down.unflatten(-1, (self.n_det, -1))[..., n_up:].flatten(-2)
        return env_up * fs_up, env_down * fs_down, jastrow

    def forward(self, phys_conf: PhysicalConfiguration, return_mos: bool = False):
        """``Psi``, or with ``return_mos`` the orbitals of each spin unpacked
        from the flat det-major layout into ``[B, n_det, n_spin, n_orb]``
        (the pretraining targets' layout, as the JAX package's cold path)."""
        orb_up, orb_down, jastrow = self._orbitals_and_jastrow(phys_conf)
        if return_mos:
            return tuple(o.unflatten(-1, (self.n_det, -1)).movedim(-2, -3)
                         for o in (orb_up, orb_down))
        sign, log_psi = self._determinant_mix(orb_up, orb_down)
        if self.cusp_electrons is not None:
            log_psi = log_psi + self.cusp_electrons(phys_conf.r)
        if jastrow is not None:
            log_psi = log_psi + jastrow
        return Psi(sign, log_psi)
