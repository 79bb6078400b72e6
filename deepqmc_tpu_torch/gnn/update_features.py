"""Update features (counterpart of ``deepqmc_tpu/gnn/update_features.py``):
the PsiFormer self-attention update only."""

import torch

from .. import nn
from ..fwdlap import FL, is_fl, tanh
from ..ops import fl_block

__all__ = ['NodeAttentionElectronUpdateFeature']


class NodeAttentionElectronUpdateFeature(nn.Module):
    """PsiFormer block: attention + residual, then a tanh MLP + residual.

    With ``block_kernel`` the forward Laplacian of the whole block goes through
    :func:`ops.fl_block.psiformer_block_fl` (one kernel launch on the card), the
    counterpart of the JAX package's fused rule for the named-jit block
    ``_psiformer_block`` (``fwdlap._try_block_rule``), wherever
    :func:`ops.fl_block.takes` says the kernel takes the shape: on the card
    up to 32 electrons (its shared memory).  Above that the block runs the
    per-op FL rules, as the JAX rule falls back to per-primitive
    interpretation.  Plain tensors, such as the sampler's forwards, always
    take the per-op forward.
    """

    def __init__(self, embedding_dim: int, *, num_heads: int, gen: torch.Generator,
                 block_kernel: bool = False):
        super().__init__('node_attention_electron_update_feature')
        head_dim, rem = divmod(embedding_dim, num_heads)
        if rem:
            raise ValueError('embedding_dim must be divisible by num_heads')
        self.block_kernel = block_kernel
        self.attention = nn.MultiHeadAttention(embedding_dim, num_heads, head_dim, gen=gen)
        self.mlp = nn.MLP(
            embedding_dim, embedding_dim, gen=gen, hidden_layers=['log', 2], bias=True,
            last_linear=False, activation=tanh, init='ferminet',
        )
        self.residual = nn.ResidualConnection()

    def block_weights(self):
        """(Wq, Wk, Wv, Wo, W1, b1, W2, b2), the weight operands of the fused block."""
        att, (lin1, lin2) = self.attention, self.mlp.layers
        return att.query.w, att.key.w, att.value.w, att.w, lin1.w, lin1.b, lin2.w, lin2.b

    def forward(self, h):
        if self.block_kernel and is_fl(h) and fl_block.takes(h.x):
            y, jy, ly = fl_block.psiformer_block_fl(
                h.x, h.jac, h.lap, *self.block_weights(), self.attention.num_heads
            )
            return FL(y, jy, ly)
        attended = self.residual(h, self.attention(h, h, h))
        return self.residual(attended, self.mlp(attended))
