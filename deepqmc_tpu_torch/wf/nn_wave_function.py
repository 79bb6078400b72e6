"""The neural-network wave function (counterpart of
``deepqmc_tpu/wf/nn_wave_function.py``) in the PsiFormer configuration:
envelopes times backflow give flat det-major orbitals ``[n, D*n]`` per spin,
full determinants over the row concatenation, an exp-normalised sum over
determinants (``SumPool``), plus the electronic cusp."""

import torch

from .. import fwdlap as fl
from .. import nn
from ..types import PhysicalConfiguration, Psi

__all__ = ['NeuralNetworkWaveFunction']


class NeuralNetworkWaveFunction(nn.Module):
    """``phys_conf -> Psi(sign [B], log [B])``; ``phys_conf.r`` may be an FL,
    in which case ``log`` is an FL carrying its gradient and Laplacian."""

    def __init__(self, hamil, *, n_determinants, omni, envelope, cusp_electrons):
        super().__init__('neural_network_wave_function')
        self.n_det = n_determinants
        self.omni = omni
        self.envelope = envelope
        self.cusp_electrons = cusp_electrons
        self.conf_coeff = nn.SumPool()

    def _determinant_mix(self, orb_up, orb_down):
        """Slater determinants -> exp-normalised sum over determinants."""
        sign, logdet = fl.slogdet_flat_rows(orb_up, orb_down, self.n_det)
        # the shift cancels exactly in log|psi|, so it is a constant here
        shift = fl.primal(logdet).amax(-1, keepdim=True)
        shift = torch.where(torch.isinf(shift), torch.zeros_like(shift), shift)
        psi = self.conf_coeff(sign * fl.exp(logdet - shift)).squeeze(-1)
        return torch.sign(fl.primal(psi)), fl.log(fl.abs(psi)) + shift.squeeze(-1)

    def _spin_orbitals(self, phys_conf: PhysicalConfiguration):
        """Per-spin flat orbital matrices ``[B, n_spin, n_det * n]`` (envelope
        times backflow); FLs when ``phys_conf.r`` is one."""
        r, R = phys_conf.r, phys_conf.R
        fs_up, fs_down = self.omni(r, R)
        env_up, env_down = self.envelope(r, R)
        return env_up * fs_up, env_down * fs_down

    def forward(self, phys_conf: PhysicalConfiguration, return_mos: bool = False):
        """``Psi``, or with ``return_mos`` the orbitals of each spin unpacked
        from the flat det-major layout into ``[B, n_det, n_spin, n_orb]``
        (the pretraining targets' layout, as the JAX package's cold path)."""
        orb_up, orb_down = self._spin_orbitals(phys_conf)
        if return_mos:
            return tuple(o.unflatten(-1, (self.n_det, -1)).movedim(-2, -3)
                         for o in (orb_up, orb_down))
        sign, log_psi = self._determinant_mix(orb_up, orb_down)
        if self.cusp_electrons is not None:
            log_psi = log_psi + self.cusp_electrons(phys_conf.r)
        return Psi(sign, log_psi)
