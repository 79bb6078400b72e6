"""Update features (counterpart of ``deepqmc_tpu/gnn/update_features.py``):
the PsiFormer self-attention update only."""

import torch

from .. import nn
from ..fwdlap import tanh

__all__ = ['NodeAttentionElectronUpdateFeature']


class NodeAttentionElectronUpdateFeature(nn.Module):
    """PsiFormer block: attention + residual, then a tanh MLP + residual."""

    def __init__(self, embedding_dim: int, *, num_heads: int, gen: torch.Generator):
        super().__init__('node_attention_electron_update_feature')
        head_dim, rem = divmod(embedding_dim, num_heads)
        if rem:
            raise ValueError('embedding_dim must be divisible by num_heads')
        self.attention = nn.MultiHeadAttention(embedding_dim, num_heads, head_dim, gen=gen)
        self.mlp = nn.MLP(
            embedding_dim, embedding_dim, gen=gen, hidden_layers=['log', 2], bias=True,
            last_linear=False, activation=tanh, init='ferminet',
        )
        self.residual = nn.ResidualConnection()

    def forward(self, h):
        attended = self.residual(h, self.attention(h, h, h))
        return self.residual(attended, self.mlp(attended))
