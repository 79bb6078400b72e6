"""Ansatz presets (counterpart of ``deepqmc_tpu/presets.py``): PsiFormer only."""

from typing import Optional

import torch

from .gnn import ElectronGNN
from .gnn.edge_features import (
    CombinedEdgeFeature,
    DifferenceEdgeFeature,
    DistancePowerEdgeFeature,
)
from .wf import NeuralNetworkWaveFunction
from .wf.cusp import ElectronicCuspAsymptotic, PsiformerCusp
from .wf.env import ExponentialEnvelopes
from .wf.omni import OmniNet

__all__ = ['psiformer_ansatz']


def psiformer_ansatz(
    hamil,
    *,
    n_determinants: int = 16,
    embedding_dim: int = 256,
    n_interactions: int = 4,
    num_heads: int = 4,
    seed: int = 0,
    gen: Optional[torch.Generator] = None,
    block_kernel: bool = False,
) -> NeuralNetworkWaveFunction:
    """The PsiFormer (``presets.psiformer_ansatz``, full determinants) with
    parameters drawn from a seeded generator, in float32 on the CPU; move it
    with ``.to(device, dtype)``.

    ``block_kernel`` mirrors the JAX package's ``DEEPQMC_TPU_BLOCK_KERNEL``
    switch (``fwdlap._use_block_kernel``): each attention layer's forward
    Laplacian becomes one fused block (:func:`ops.fl_block.psiformer_block_fl`,
    one kernel launch per layer on the card) instead of the per-op rules.  It
    also covers ``DEEPQMC_TPU_GNN_STACK_BLOCK``, which computes the same
    function, as one launch per layer.  The parameters do not depend on it.
    """
    gen = gen or torch.Generator().manual_seed(seed)
    n = hamil.n_up + hamil.n_down
    ne_features = CombinedEdgeFeature(features=[
        DistancePowerEdgeFeature(powers=[1], log_rescale=True),
        DifferenceEdgeFeature(log_rescale=True),
    ])
    gnn = ElectronGNN(
        hamil, embedding_dim, n_interactions=n_interactions, num_heads=num_heads,
        ne_features=ne_features, gen=gen, block_kernel=block_kernel,
    )
    return NeuralNetworkWaveFunction(
        hamil,
        n_determinants=n_determinants,
        omni=OmniNet(hamil, n, n_determinants, gnn=gnn, gen=gen),
        envelope=ExponentialEnvelopes(hamil, n_determinants),
        cusp_electrons=ElectronicCuspAsymptotic(
            hamil.n_up, hamil.n_down, same_scale=0.25, anti_scale=0.5, alpha=1.0,
            cusp_function=PsiformerCusp(),
        ),
    )
