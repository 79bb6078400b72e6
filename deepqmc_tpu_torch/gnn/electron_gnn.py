"""The electron GNN as the PsiFormer preset configures it (counterpart of
``deepqmc_tpu/gnn/electron_gnn.py``): no edges, no nuclear embeddings, a
positional electron embedding, and layers whose only update feature is
self-attention, folded by the 'concatenate' rule through an identity net."""

import torch

from .. import fwdlap as fl
from .. import nn
from .update_features import NodeAttentionElectronUpdateFeature

__all__ = ['ElectronEmbedding', 'ElectronGNN', 'ElectronGNNLayer']


class ElectronEmbedding(nn.Module):
    """Electron-nucleus edge features per electron (+ spin), projected to the
    embedding width by a bias-free linear layer."""

    def __init__(self, n_nuc, n_up, n_down, embedding_dim, *, ne_features, gen):
        super().__init__('electron_embedding')
        self.ne_features = ne_features
        spin = torch.cat([torch.ones(n_up), -torch.ones(n_down)])[:, None]
        self.register_buffer('spin', spin, persistent=False)
        in_dim = n_nuc * len(ne_features) + 1
        self.linear = nn.Linear(in_dim, embedding_dim, gen=gen, with_bias=False)

    def forward(self, r, R):
        # [B, n_el, n_nuc, 3] receiver (electron) minus sender (nucleus)
        feats = self.ne_features(r[..., :, None, :] - R).flatten(-2)
        return self.linear(fl.cat([feats, self.spin.to(feats.dtype)], -1))


class ElectronGNNLayer(nn.Module):
    """One interaction: the attention update's message, folded by the
    'concatenate' rule (one message) through the identity net ``g``, replaces
    the electron embeddings (no residual)."""

    def __init__(self, ilayer, embedding_dim, *, num_heads, gen, block_kernel=False):
        super().__init__('electron_gnnlayer' if ilayer == 0 else f'electron_gnnlayer_{ilayer}')
        self.update = NodeAttentionElectronUpdateFeature(
            embedding_dim, num_heads=num_heads, gen=gen, block_kernel=block_kernel
        )
        self.g = nn.Identity()

    def forward(self, h):
        return self.g(self.update(h))


class ElectronGNN(nn.Module):
    """Embedding followed by ``n_interactions`` attention layers; with
    ``block_kernel`` each layer's forward Laplacian is one fused block."""

    def __init__(self, hamil, embedding_dim, *, n_interactions, num_heads, ne_features, gen,
                 block_kernel=False):
        super().__init__('electron_gnn')
        self.embedding_dim = embedding_dim
        self.electron_embedding = ElectronEmbedding(
            hamil.n_nuc, hamil.n_up, hamil.n_down, embedding_dim, ne_features=ne_features, gen=gen
        )
        self.layers = torch.nn.ModuleList(
            ElectronGNNLayer(i, embedding_dim, num_heads=num_heads, gen=gen,
                             block_kernel=block_kernel)
            for i in range(n_interactions)
        )

    def forward(self, r, R):
        h = self.electron_embedding(r, R)
        for layer in self.layers:
            h = layer(h)
        return h
