"""OmniNet (counterpart of ``deepqmc_tpu/wf/omni.py``): the GNN's electron
embeddings feed an optional Jastrow factor and one backflow head per spin;
no nuclear head."""

from .. import nn

__all__ = ['Backflow', 'Jastrow', 'OmniNet']


class Jastrow(nn.Module):
    """Deep Jastrow factor ``[B]`` from the embeddings: with ``sum_first`` the
    embeddings are summed over the electrons before the net ``subnet_factory(
    embedding_dim, 1)``, else its outputs are."""

    def __init__(self, embedding_dim, *, sum_first, subnet_factory):
        super().__init__('jastrow')
        self.net = subnet_factory(embedding_dim, 1)
        self.sum_first = sum_first

    def forward(self, xs):
        out = self.net(xs.sum(-2)) if self.sum_first else self.net(xs).sum(-2)
        return out.squeeze(-1)


class Backflow(nn.Module):
    """Per-electron ``[n_det * n_orb]`` multiplicative backflow factors (one
    head, det-major columns) from ``subnet_factory(embedding_dim, n_det * n_orb)``."""

    def __init__(self, embedding_dim, n_orbitals, n_determinants, *, subnet_factory, name):
        super().__init__(name)
        self.mlp = subnet_factory(embedding_dim, n_orbitals * n_determinants)

    def forward(self, xs):
        return self.mlp(xs)


class OmniNet(nn.Module):
    """``n_orb_up``/``n_orb_down`` are the spin electron counts, or the
    electron count for full determinants."""

    def __init__(self, hamil, n_orb_up, n_orb_down, n_determinants, *, gnn, backflow_factory,
                 jastrow_factory=None):
        super().__init__('omni_net')
        self.n_up = hamil.n_up
        self.gnn = gnn
        self.jastrow = jastrow_factory(gnn.embedding_dim) if jastrow_factory else None
        self.backflow_up = Backflow(gnn.embedding_dim, n_orb_up, n_determinants,
                                    subnet_factory=backflow_factory, name='backflow')
        self.backflow_down = Backflow(gnn.embedding_dim, n_orb_down, n_determinants,
                                      subnet_factory=backflow_factory, name='backflow_1')

    def forward(self, r, R):
        """(Jastrow ``[B]`` or None, backflow factors ``([B, n_up, D*n_orb_up],
        [B, n_down, D*n_orb_down])``)."""
        h = self.gnn(r, R)
        jastrow = self.jastrow(h) if self.jastrow is not None else None
        return jastrow, (self.backflow_up(h[..., : self.n_up, :]),
                         self.backflow_down(h[..., self.n_up :, :]))
