"""OmniNet in the PsiFormer configuration (counterpart of ``deepqmc_tpu/wf/omni.py``):
the GNN's electron embeddings feed one backflow head per spin; no Jastrow and
no nuclear head."""

from .. import nn

__all__ = ['Backflow', 'OmniNet']


class Backflow(nn.Module):
    """Per-electron ``[n_det * n_orb]`` multiplicative backflow factors (one head)."""

    def __init__(self, embedding_dim, n_orbitals, n_determinants, *, gen, name):
        super().__init__(name)
        self.mlp = nn.MLP(
            embedding_dim, n_orbitals * n_determinants, gen=gen, hidden_layers=['log', 1],
            bias=False, last_linear=True, activation=None, init='ferminet',
        )

    def forward(self, xs):
        return self.mlp(xs)


class OmniNet(nn.Module):
    def __init__(self, hamil, n_orb, n_determinants, *, gnn, gen):
        super().__init__('omni_net')
        self.n_up = hamil.n_up
        self.gnn = gnn
        self.backflow_up = Backflow(gnn.embedding_dim, n_orb, n_determinants, gen=gen,
                                    name='backflow')
        self.backflow_down = Backflow(gnn.embedding_dim, n_orb, n_determinants, gen=gen,
                                      name='backflow_1')

    def forward(self, r, R):
        """Backflow factors ``([B, n_up, D*n], [B, n_down, D*n])``."""
        h = self.gnn(r, R)
        return self.backflow_up(h[..., : self.n_up, :]), self.backflow_down(h[..., self.n_up :, :])
