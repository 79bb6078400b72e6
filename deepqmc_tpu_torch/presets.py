"""Ansatz presets (counterpart of ``deepqmc_tpu/presets.py``): the
PauliNet-style ``default``, FermiNet and the PsiFormer, each with the JAX
factory's keyword arguments and defaults, and parameters drawn from a seeded
generator with the JAX package's initialisers, in float32 on the CPU; move
a network with ``.to(device, dtype)``."""

from functools import partial
from typing import Optional

import torch

from . import nn
from .fwdlap import tanh
from .gnn import ElectronGNN, ElectronGNNLayer
from .gnn.edge_features import (
    CombinedEdgeFeature,
    DifferenceEdgeFeature,
    DistancePowerEdgeFeature,
)
from .gnn.electron_gnn import ElectronEmbedding
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
from .wf.omni import Jastrow, OmniNet

__all__ = ['ansatz_from_config', 'ansatz_preset', 'default_ansatz', 'ferminet_ansatz',
           'psiformer_ansatz']


def _dist_diff_features(log_rescale=False):
    return CombinedEdgeFeature(features=[
        DistancePowerEdgeFeature(powers=[1], log_rescale=log_rescale),
        DifferenceEdgeFeature(log_rescale=log_rescale),
    ])


def _mlp(gen, hidden_layers, bias, last_linear, activation, init):
    """A subnet factory ``(in_dim, out_dim, name='mlp') -> MLP``."""
    return partial(nn.MLP, gen=gen, hidden_layers=hidden_layers, bias=bias,
                   last_linear=last_linear, activation=activation, init=init)


def _identity(*args, **kwargs):
    return nn.Identity()


def _wave_function(hamil, gnn, *, n_determinants, full_determinant, backflow_init,
                   jastrow_factory=None, cusp_electrons=None, conf_coeff=None, gen):
    """The parts the three presets share: one backflow head per spin, the
    isotropic per-orbital envelopes, full or per-spin determinants."""
    n = hamil.n_up + hamil.n_down
    n_orb = (n, n) if full_determinant else (hamil.n_up, hamil.n_down)
    omni = OmniNet(hamil, *n_orb, n_determinants, gnn=gnn, jastrow_factory=jastrow_factory,
                   backflow_factory=_mlp(gen, ['log', 1], False, True, None, backflow_init))
    return NeuralNetworkWaveFunction(
        hamil, n_determinants=n_determinants, omni=omni,
        envelope=ExponentialEnvelopes(hamil, n_determinants), cusp_electrons=cusp_electrons,
        full_determinant=full_determinant, conf_coeff=conf_coeff,
    )


def _check_spins(hamil, preset):
    # the JAX package's node and edge sums over an empty spin block give NaN
    # (FermiNet) or fail to build (default): ROADMAP.md, queue 3
    if hamil.n_down == 0:
        raise ValueError(f'the {preset} preset needs at least one electron of each spin '
                         f'(n_up={hamil.n_up}, n_down=0)')


def default_ansatz(
    hamil,
    *,
    n_determinants: int = 16,
    full_determinant: bool = True,
    embedding_dim: int = 128,
    n_interactions: int = 3,
    two_particle_stream_dim: int = 32,
    seed: int = 0,
    gen: Optional[torch.Generator] = None,
) -> NeuralNetworkWaveFunction:
    """The PauliNet-style ``default`` ansatz (``presets.default_ansatz``): a
    GNN of convolutions over same- and opposite-spin edges without
    self-edges and a shared two-particle stream, a Jastrow factor, the
    DeepQMC cusp with a fixed alpha of 10, and a trainable determinant mix
    (a bias-free linear layer started at ones)."""
    _check_spins(hamil, 'default')
    gen = gen or torch.Generator().manual_seed(seed)
    subnet = _mlp(gen, ['log', 2], True, False, tanh, 'default')
    layer_factory = partial(
        ElectronGNNLayer,
        update_features=[
            ResidualElectronUpdateFeature,
            partial(NodeSumElectronUpdateFeature, node_types=['up', 'down'], normalize=True),
            partial(ConvolutionElectronUpdateFeature, edge_types=['same', 'anti'],
                    normalize=False, w_factory=subnet, h_factory=subnet),
        ],
        subnet_factory=subnet,
        subnet_factory_by_lbl={'g': _mlp(gen, ['log', 1], False, False, tanh, 'default')},
        electron_residual=nn.ResidualConnection(normalize=True),
        two_particle_residual=nn.ResidualConnection(normalize=True),
        deep_features='shared',
    )
    gnn = ElectronGNN(
        hamil, embedding_dim, n_interactions=n_interactions,
        electron_embedding=ElectronEmbedding(
            hamil.n_nuc, hamil.n_up, hamil.n_down, embedding_dim,
            ne_features=_dist_diff_features(), gen=gen, use_spin=False,
            project_to_embedding_dim=False),
        layer_factory=layer_factory,
        edge_features={'same': _dist_diff_features(), 'anti': _dist_diff_features()},
        self_interaction=False, two_particle_stream_dim=two_particle_stream_dim,
    )
    return _wave_function(
        hamil, gnn, n_determinants=n_determinants, full_determinant=full_determinant,
        backflow_init='default', gen=gen,
        jastrow_factory=partial(
            Jastrow, sum_first=True,
            subnet_factory=_mlp(gen, ['log', 1], False, True, None, 'default')),
        cusp_electrons=ElectronicCuspAsymptotic(
            hamil.n_up, hamil.n_down, same_scale=0.25, anti_scale=0.5, alpha=10.0,
            trainable_alpha=False, cusp_function=DeepQMCCusp()),
        conf_coeff=nn.Linear(n_determinants, 1, gen=gen, with_bias=False, w_init=nn.ones_init,
                             name='conf_coeff'),
    )


def ferminet_ansatz(
    hamil,
    *,
    n_determinants: int = 16,
    full_determinant: bool = True,
    embedding_dim: int = 256,
    n_interactions: int = 4,
    two_particle_stream_dim: int = 32,
    seed: int = 0,
    gen: Optional[torch.Generator] = None,
) -> NeuralNetworkWaveFunction:
    """FermiNet (``presets.ferminet_ansatz``): per-spin node means and edge
    means over up and down senders (self-edges kept), a shared two-particle
    stream, no cusp and no Jastrow, the determinants summed."""
    _check_spins(hamil, 'ferminet')
    gen = gen or torch.Generator().manual_seed(seed)
    subnet = _mlp(gen, ['log', 1], True, False, tanh, 'ferminet')
    layer_factory = partial(
        ElectronGNNLayer,
        update_features=[
            ResidualElectronUpdateFeature,
            partial(NodeSumElectronUpdateFeature, node_types=['up', 'down'], normalize=True),
            partial(EdgeSumElectronUpdateFeature, edge_types=['up', 'down'], normalize=True),
        ],
        subnet_factory=subnet,
        electron_residual=nn.ResidualConnection(normalize=True),
        two_particle_residual=nn.ResidualConnection(normalize=True),
        deep_features='shared',
    )
    gnn = ElectronGNN(
        hamil, embedding_dim, n_interactions=n_interactions,
        electron_embedding=ElectronEmbedding(
            hamil.n_nuc, hamil.n_up, hamil.n_down, embedding_dim,
            ne_features=_dist_diff_features(), gen=gen, use_spin=False,
            project_to_embedding_dim=False),
        layer_factory=layer_factory,
        edge_features={'up': _dist_diff_features(), 'down': _dist_diff_features()},
        self_interaction=True, two_particle_stream_dim=two_particle_stream_dim,
    )
    return _wave_function(hamil, gnn, n_determinants=n_determinants,
                          full_determinant=full_determinant, backflow_init='ferminet', gen=gen)


def psiformer_ansatz(
    hamil,
    *,
    n_determinants: int = 16,
    full_determinant: bool = True,
    embedding_dim: int = 256,
    n_interactions: int = 4,
    num_heads: int = 4,
    seed: int = 0,
    gen: Optional[torch.Generator] = None,
    block_kernel: bool = False,
) -> NeuralNetworkWaveFunction:
    """The PsiFormer (``presets.psiformer_ansatz``): self-attention layers
    without edges, the PsiFormer cusp with a trainable alpha, the
    determinants summed.

    ``block_kernel`` mirrors the JAX package's ``DEEPQMC_TPU_BLOCK_KERNEL``
    switch (``fwdlap._use_block_kernel``): each attention layer's forward
    Laplacian becomes one fused block (:func:`ops.fl_block.psiformer_block_fl`,
    one kernel launch per layer on the card) instead of the per-op rules.  It
    also covers ``DEEPQMC_TPU_GNN_STACK_BLOCK``, which computes the same
    function, as one launch per layer.  The parameters do not depend on it.
    """
    gen = gen or torch.Generator().manual_seed(seed)

    def attention(n_up, n_down, two_particle_stream_dim, node_dim, edge_dim):
        return NodeAttentionElectronUpdateFeature(node_dim, num_heads=num_heads, gen=gen,
                                                  block_kernel=block_kernel)

    gnn = ElectronGNN(
        hamil, embedding_dim, n_interactions=n_interactions,
        electron_embedding=ElectronEmbedding(
            hamil.n_nuc, hamil.n_up, hamil.n_down, embedding_dim,
            ne_features=_dist_diff_features(log_rescale=True), gen=gen),
        layer_factory=partial(ElectronGNNLayer, update_features=[attention],
                              subnet_factory=_identity),
    )
    return _wave_function(
        hamil, gnn, n_determinants=n_determinants, full_determinant=full_determinant,
        backflow_init='ferminet', gen=gen,
        cusp_electrons=ElectronicCuspAsymptotic(
            hamil.n_up, hamil.n_down, same_scale=0.25, anti_scale=0.5, alpha=1.0,
            cusp_function=PsiformerCusp()),
    )


_PRESETS = {
    'default': default_ansatz,
    'ferminet': ferminet_ansatz,
    'psiformer': psiformer_ansatz,
}


def ansatz_preset(name: str, **overrides):
    """An ansatz factory ``hamil -> wave function`` for a named preset, as
    the JAX package's ``ansatz_preset``."""
    if name == 'deeperwin':
        raise NotImplementedError('the deeperwin preset is not ported yet (ROADMAP.md, queue 1 '
                                  'item 8)')
    if name not in _PRESETS:
        raise ValueError(f'unknown ansatz preset {name!r}; the port has {sorted(_PRESETS)}')
    return partial(_PRESETS[name], **overrides)


# the keys of a composed ansatz tree (``conf/ansatz/*``) the port builds when a
# user overrides them, and the preset keyword each sets
_TREE_KEYS = {
    'n_determinants': 'n_determinants',
    'full_determinant': 'full_determinant',
    'omni_factory.embedding_dim': 'embedding_dim',
    'omni_factory.gnn_factory.n_interactions': 'n_interactions',
}
_PRESET_TREE_KEYS = {
    'default': {'omni_factory.gnn_factory.two_particle_stream_dim': 'two_particle_stream_dim'},
    'ferminet': {'omni_factory.gnn_factory.two_particle_stream_dim': 'two_particle_stream_dim'},
    'psiformer': {
        'omni_factory.gnn_factory.layer_factory.update_features.0.num_heads': 'num_heads',
    },
}
_ABSENT = object()


def _leaves(node, prefix=''):
    """``(dotted path, value)`` of every leaf of a config tree (list entries by index)."""
    items = (node.items() if isinstance(node, dict)
             else enumerate(node) if isinstance(node, list) else None)
    if not items:
        yield prefix, node
        return
    for k, v in items:
        yield from _leaves(v, f'{prefix}.{k}' if prefix else str(k))


def ansatz_from_config(node: dict, **kwargs):
    """The ansatz factory ``(hamil, gen=...) -> module`` of a composed ansatz
    tree of ``conf/ansatz`` (the reader of ``config.TREE_READERS``).

    The tree is matched to the packaged preset it differs least from; each
    key where it differs must be one of :data:`_TREE_KEYS` (or the preset's
    own), and becomes that keyword of the preset.  Any other difference
    raises, naming the key: the port builds the three presets' networks
    only.  ``kwargs`` go to the preset (``block_kernel``, ``seed``)."""
    from .conf.ansatz import OPTIONS

    leaves = dict(_leaves(node))

    def differing(name):
        ref = dict(_leaves(OPTIONS[name]))
        return {p for p in ref.keys() | leaves.keys()
                if ref.get(p, _ABSENT) != leaves.get(p, _ABSENT)}

    name = min(OPTIONS, key=lambda n: len(differing(n)))
    if name not in _PRESETS:
        return ansatz_preset(name)  # raises: not ported
    allowed = {**_TREE_KEYS, **_PRESET_TREE_KEYS[name]}
    overrides = {}
    for path in sorted(differing(name), key=lambda p: (p.count('.'), p)):
        if path not in allowed or path not in leaves:
            raise NotImplementedError(
                f'ansatz.{path}: the port builds the {name} ansatz with overrides of '
                f'{", ".join(f"ansatz.{k}" for k in allowed)} only; the other options of '
                'the tree are not ported yet (ROADMAP.md, queue 1 item 8)')
        overrides[allowed[path]] = leaves[path]
    return ansatz_preset(name, **overrides, **kwargs)
