"""Ansatz presets (counterpart of ``deepqmc_tpu/presets.py``): the
PauliNet-style ``default``, FermiNet, the PsiFormer and DeepErwin, each the
JAX factory's tree of partials over the port's classes with the JAX
factory's keyword arguments and defaults.

A preset and a composed ``conf/ansatz`` tree (:func:`ansatz_from_config`)
take one path, :func:`build_ansatz`: the ``NeuralNetworkWaveFunction`` built
from its keyword arguments inside one seeded generator, parameters drawn
with the JAX package's initialisers, in float32 on the CPU; move a network
with ``.to(device, dtype)``.
"""

from functools import partial
from typing import Optional

import torch

from . import fwdlap as fl
from . import nn
from .gnn import ElectronGNN, ElectronGNNLayer
from .gnn.edge_features import (
    CombinedEdgeFeature,
    DifferenceEdgeFeature,
    DistancePowerEdgeFeature,
)
from .gnn.electron_gnn import ElectronEmbedding, NucleiEmbedding
from .gnn.update_features import (
    ConvolutionElectronUpdateFeature,
    EdgeSumElectronUpdateFeature,
    NodeAttentionElectronUpdateFeature,
    NodeSumElectronUpdateFeature,
    ResidualElectronUpdateFeature,
)
from .wf import NeuralNetworkWaveFunction
from .wf.cusp import DeepQMCCusp, ElectronicCuspAsymptotic, PsiformerCusp
from .wf.env import ExponentialEnvelopes
from .wf.nn_wave_function import BackflowOp
from .wf.omni import Backflow, Jastrow, OmniNet

__all__ = ['ansatz_from_config', 'ansatz_preset', 'build_ansatz', 'deeperwin_ansatz',
           'default_ansatz', 'ferminet_ansatz', 'psiformer_ansatz']


def build_ansatz(hamil, wf_kwargs: dict, *, seed: int = 0,
                 gen: Optional[torch.Generator] = None, block_kernel: bool = False):
    """``NeuralNetworkWaveFunction(hamil, **wf_kwargs)``, its parameters drawn
    from ``gen`` (else a generator seeded with ``seed``).

    ``block_kernel`` mirrors the JAX package's ``DEEPQMC_TPU_BLOCK_KERNEL``
    switch (``fwdlap._use_block_kernel``): each attention layer's forward
    Laplacian becomes one fused block (:func:`ops.fl_block.psiformer_block_fl`,
    one kernel launch per layer on the card) instead of the per-op rules.  It
    also covers ``DEEPQMC_TPU_GNN_STACK_BLOCK``, which computes the same
    function, as one launch per layer.  The parameters do not depend on it;
    an ansatz without the PsiFormer's blocks refuses it.
    """
    with nn.init_generator(gen or torch.Generator().manual_seed(seed)):
        wf = NeuralNetworkWaveFunction(hamil, **wf_kwargs)
    if block_kernel:
        blocks = [m for m in wf.modules() if isinstance(m, NodeAttentionElectronUpdateFeature)]
        if not blocks:
            raise ValueError('block_kernel: the ansatz has no PsiFormer attention block')
        for m in blocks:
            m.use_block_kernel()
    return wf


def _dist_diff_features(log_rescale=False):
    return CombinedEdgeFeature(features=[
        DistancePowerEdgeFeature(powers=[1], log_rescale=log_rescale),
        DifferenceEdgeFeature(log_rescale=log_rescale),
    ])


def _mlp(hidden_layers, bias, last_linear, activation, init):
    """A subnet factory ``(in_dim, out_dim, name=None) -> MLP``."""
    return partial(nn.MLP, hidden_layers=hidden_layers, bias=bias, last_linear=last_linear,
                   activation=activation, init=init)


def _envelope(softplus_zeta=False):
    return partial(ExponentialEnvelopes, isotropic=True, per_shell=False,
                   per_orbital_exponent=True, spin_restricted=False, init_to_ones=True,
                   softplus_zeta=softplus_zeta)


def _electron_embedding(log_rescale=False, use_spin=False, project_to_embedding_dim=False):
    return partial(ElectronEmbedding,
                   positional_embeddings={'ne': _dist_diff_features(log_rescale)},
                   use_spin=use_spin, project_to_embedding_dim=project_to_embedding_dim)


def _wave_function(*, gnn_factory, embedding_dim, backflow_init, n_determinants,
                   full_determinant, conf_coeff=nn.SumPool, jastrow_factory=None,
                   cusp_electrons=None, backflow_activation=None, softplus_zeta=False):
    """The keyword arguments of ``NeuralNetworkWaveFunction`` the presets share:
    one backflow head per spin, the isotropic per-orbital envelopes, a
    multiplicative backflow, no nuclear cusp and no nuclear head."""
    return dict(
        omni_factory=partial(
            OmniNet, embedding_dim=embedding_dim, jastrow_factory=jastrow_factory,
            backflow_factory=partial(Backflow, subnet_factory=_mlp(
                ['log', 1], False, True, backflow_activation, backflow_init)),
            nuclear_gnn_head=None, gnn_factory=gnn_factory),
        envelope=_envelope(softplus_zeta),
        backflow_op=partial(BackflowOp, mult_act=lambda x: x),
        n_determinants=n_determinants, full_determinant=full_determinant,
        cusp_electrons=cusp_electrons, cusp_nuclei=None, backflow_transform='mult',
        conf_coeff=conf_coeff,
    )


def default_ansatz(hamil, *, n_determinants: int = 16, full_determinant: bool = True,
                   embedding_dim: int = 128, n_interactions: int = 3,
                   two_particle_stream_dim: int = 32, **build_kwargs):
    """The PauliNet-style ``default`` ansatz (``presets.default_ansatz``): a
    GNN of convolutions over same- and opposite-spin edges without
    self-edges and a shared two-particle stream, a Jastrow factor, the
    DeepQMC cusp with a fixed alpha of 10, and a trainable determinant mix
    (a bias-free linear layer started at ones)."""
    subnet = _mlp(['log', 2], True, False, fl.tanh, 'default')
    gnn_factory = partial(
        ElectronGNN, n_interactions=n_interactions, nuclei_embedding=None,
        electron_embedding=_electron_embedding(),
        two_particle_stream_dim=two_particle_stream_dim, self_interaction=False,
        edge_features={'same': _dist_diff_features(), 'anti': _dist_diff_features()},
        layer_factory=partial(
            ElectronGNNLayer, subnet_factory=subnet,
            subnet_factory_by_lbl={'g': _mlp(['log', 1], False, False, fl.tanh, 'default')},
            electron_residual=nn.ResidualConnection(normalize=True), nucleus_residual=None,
            two_particle_residual=nn.ResidualConnection(normalize=True),
            deep_features='shared', update_rule='concatenate',
            update_features=[
                ResidualElectronUpdateFeature,
                partial(NodeSumElectronUpdateFeature, node_types=['up', 'down'],
                        normalize=True),
                partial(ConvolutionElectronUpdateFeature, edge_types=['same', 'anti'],
                        normalize=False, w_factory=subnet, h_factory=subnet),
            ]),
    )
    return build_ansatz(hamil, _wave_function(
        gnn_factory=gnn_factory, embedding_dim=embedding_dim, backflow_init='default',
        n_determinants=n_determinants, full_determinant=full_determinant,
        jastrow_factory=partial(Jastrow, sum_first=True,
                                subnet_factory=_mlp(['log', 1], False, True, None, 'default')),
        cusp_electrons=partial(ElectronicCuspAsymptotic, same_scale=0.25, anti_scale=0.5,
                               alpha=10.0, trainable_alpha=False, cusp_function=DeepQMCCusp()),
        conf_coeff=partial(nn.Linear, with_bias=False, w_init=nn.ones_init),
    ), **build_kwargs)


def ferminet_ansatz(hamil, *, n_determinants: int = 16, full_determinant: bool = True,
                    embedding_dim: int = 256, n_interactions: int = 4,
                    two_particle_stream_dim: int = 32, **build_kwargs):
    """FermiNet (``presets.ferminet_ansatz``): per-spin node means and edge
    means over up and down senders (self-edges kept), a shared two-particle
    stream, no cusp and no Jastrow, the determinants summed."""
    subnet = _mlp(['log', 1], True, False, fl.tanh, 'ferminet')
    gnn_factory = partial(
        ElectronGNN, n_interactions=n_interactions, nuclei_embedding=None,
        electron_embedding=_electron_embedding(),
        two_particle_stream_dim=two_particle_stream_dim, self_interaction=True,
        edge_features={'up': _dist_diff_features(), 'down': _dist_diff_features()},
        layer_factory=partial(
            ElectronGNNLayer, subnet_factory=subnet,
            electron_residual=nn.ResidualConnection(normalize=True), nucleus_residual=False,
            two_particle_residual=nn.ResidualConnection(normalize=True),
            deep_features='shared', update_rule='concatenate',
            update_features=[
                ResidualElectronUpdateFeature,
                partial(NodeSumElectronUpdateFeature, node_types=['up', 'down'],
                        normalize=True),
                partial(EdgeSumElectronUpdateFeature, edge_types=['up', 'down'],
                        normalize=True),
            ]),
    )
    return build_ansatz(hamil, _wave_function(
        gnn_factory=gnn_factory, embedding_dim=embedding_dim, backflow_init='ferminet',
        n_determinants=n_determinants, full_determinant=full_determinant,
    ), **build_kwargs)


def psiformer_ansatz(hamil, *, n_determinants: int = 16, full_determinant: bool = True,
                     embedding_dim: int = 256, n_interactions: int = 4, num_heads: int = 4,
                     **build_kwargs):
    """The PsiFormer (``presets.psiformer_ansatz``): self-attention layers
    without edges, the PsiFormer cusp with a trainable alpha, the
    determinants summed.  Takes ``block_kernel`` (:func:`build_ansatz`)."""
    gnn_factory = partial(
        ElectronGNN, n_interactions=n_interactions, nuclei_embedding=None,
        electron_embedding=_electron_embedding(log_rescale=True, use_spin=True,
                                               project_to_embedding_dim=True),
        two_particle_stream_dim=32, self_interaction=True, edge_features=None,
        layer_factory=partial(
            ElectronGNNLayer, subnet_factory=nn.Identity, electron_residual=False,
            nucleus_residual=False, two_particle_residual=False, deep_features=False,
            update_rule='concatenate',
            update_features=[partial(
                NodeAttentionElectronUpdateFeature, num_heads=num_heads,
                mlp_factory=_mlp(['log', 2], True, False, fl.tanh, 'ferminet'),
                attention_residual=nn.ResidualConnection(normalize=False),
                mlp_residual=nn.ResidualConnection(normalize=False))]),
    )
    return build_ansatz(hamil, _wave_function(
        gnn_factory=gnn_factory, embedding_dim=embedding_dim, backflow_init='ferminet',
        n_determinants=n_determinants, full_determinant=full_determinant,
        cusp_electrons=partial(ElectronicCuspAsymptotic, same_scale=0.25, anti_scale=0.5,
                               alpha=1.0, trainable_alpha=True, cusp_function=PsiformerCusp()),
    ), **build_kwargs)


def deeperwin_ansatz(hamil, *, n_determinants: int = 32, full_determinant: bool = True,
                     embedding_dim: int = 256, n_interactions: int = 4,
                     two_particle_stream_dim: int = 32, **build_kwargs):
    """DeepErwin (``presets.deeperwin_ansatz``): atom-type embeddings of the
    nuclei, electron-nucleus edges convolved with the nuclear embeddings,
    one two-particle net per edge type ('separate'), a softplus backflow,
    softplus envelope exponents, no cusp and no Jastrow, the determinants
    summed; every weight drawn fan-average uniform, every bias zero."""
    subnet = _mlp(['log', 1], True, False, fl.tanh, 'deeperwin')
    gnn_factory = partial(
        ElectronGNN, n_interactions=n_interactions,
        nuclei_embedding=partial(NucleiEmbedding, embedding_dim=32, atom_type_embedding=True,
                                 subnet_type='embed', edge_features=None),
        electron_embedding=_electron_embedding(),
        two_particle_stream_dim=two_particle_stream_dim, self_interaction=True,
        edge_features={'ne': _dist_diff_features(),
                       'same': DistancePowerEdgeFeature(powers=[1]),
                       'anti': DistancePowerEdgeFeature(powers=[1])},
        layer_factory=partial(
            ElectronGNNLayer, subnet_factory=subnet, electron_residual=False,
            nucleus_residual=False, two_particle_residual=nn.ResidualConnection(normalize=True),
            deep_features='separate', update_rule='concatenate',
            update_features=[
                ResidualElectronUpdateFeature,
                partial(NodeSumElectronUpdateFeature, node_types=['up', 'down'],
                        normalize=True),
                partial(ConvolutionElectronUpdateFeature, edge_types=['ee', 'ne'],
                        normalize=False, w_factory=subnet, h_factory=subnet, w_for_ne=False),
            ]),
    )
    return build_ansatz(hamil, _wave_function(
        gnn_factory=gnn_factory, embedding_dim=embedding_dim, backflow_init='deeperwin',
        n_determinants=n_determinants, full_determinant=full_determinant,
        backflow_activation=nn.ssp, softplus_zeta=True,
    ), **build_kwargs)


_PRESETS = {
    'default': default_ansatz,
    'ferminet': ferminet_ansatz,
    'psiformer': psiformer_ansatz,
    'deeperwin': deeperwin_ansatz,
}


def ansatz_preset(name: str, **overrides):
    """An ansatz factory ``hamil -> wave function`` for a named preset, as
    the JAX package's ``ansatz_preset``."""
    if name not in _PRESETS:
        raise ValueError(f'unknown ansatz preset {name!r}; the port has {sorted(_PRESETS)}')
    return partial(_PRESETS[name], **overrides)


def ansatz_from_config(node: dict, **kwargs):
    """The ansatz factory ``(hamil, gen=..., seed=..., block_kernel=...) ->
    module`` of a composed ansatz tree of ``conf/ansatz`` (the reader of
    ``config.TREE_READERS``): every node of the tree instantiated onto the
    port's counterpart of its target, and the wave function built from them
    by :func:`build_ansatz`, as the presets are.  A key the JAX class does not
    take raises its ``TypeError``, a value it refuses a ``ValueError``, when
    the factory builds.  ``kwargs`` go to :func:`build_ansatz`."""
    from .config import instantiate

    wf_kwargs = {k: instantiate(v, root=node) for k, v in node.items()
                 if k not in ('_target_', '_partial_', '_convert_')}
    return partial(build_ansatz, wf_kwargs=wf_kwargs, **kwargs)
