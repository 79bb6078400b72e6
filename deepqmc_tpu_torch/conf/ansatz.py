"""The ``ansatz`` group (``deepqmc_tpu/conf/ansatz/*.yaml``).  The port builds
these trees through :func:`..presets.ansatz_from_config`, which instantiates
each node onto the port's counterpart of its target."""

OPTIONS = {
    'deeperwin': {
        '_target_': 'deepqmc_tpu_torch.wf.NeuralNetworkWaveFunction',
        '_partial_': True,
        'envelope': {
            '_target_': 'deepqmc_tpu_torch.wf.env.ExponentialEnvelopes',
            '_partial_': True,
            'isotropic': True,
            'per_shell': False,
            'per_orbital_exponent': True,
            'spin_restricted': False,
            'init_to_ones': True,
            'softplus_zeta': True,
        },
        'backflow_op': {
            '_target_': 'deepqmc_tpu_torch.wf.nn_wave_function.BackflowOp',
            '_partial_': True,
            'mult_act': '${eval:"lambda x: x"}',
        },
        'n_determinants': 32,
        'full_determinant': True,
        'cusp_electrons': False,
        'cusp_nuclei': False,
        'backflow_transform': 'mult',
        'conf_coeff': {'_target_': 'deepqmc_tpu_torch.nn.SumPool', '_partial_': True},
        'omni_factory': {
            '_target_': 'deepqmc_tpu_torch.wf.omni.OmniNet',
            '_partial_': True,
            'embedding_dim': 256,
            'jastrow_factory': None,
            'backflow_factory': {
                '_target_': 'deepqmc_tpu_torch.wf.omni.Backflow',
                '_partial_': True,
                'subnet_factory': {
                    '_target_': 'deepqmc_tpu_torch.nn.MLP',
                    '_partial_': True,
                    'hidden_layers': ['log', 1],
                    'bias': False,
                    'last_linear': True,
                    'activation': {'_target_': 'deepqmc_tpu_torch.nn.ssp', '_partial_': True},
                    'init': 'deeperwin',
                },
            },
            'nuclear_gnn_head': False,
            'gnn_factory': {
                '_target_': 'deepqmc_tpu_torch.gnn.ElectronGNN',
                '_partial_': True,
                'n_interactions': 4,
                'nuclei_embedding': {
                    '_target_': 'deepqmc_tpu_torch.gnn.electron_gnn.NucleiEmbedding',
                    '_partial_': True,
                    'embedding_dim': 32,
                    'atom_type_embedding': True,
                    'subnet_type': 'embed',
                    'edge_features': None,
                },
                'electron_embedding': {
                    '_target_': 'deepqmc_tpu_torch.gnn.electron_gnn.ElectronEmbedding',
                    '_partial_': True,
                    'positional_embeddings': {
                        'ne': {
                            '_target_': 'deepqmc_tpu_torch.gnn.edge_features.CombinedEdgeFeature',
                            'features': [
                                {
                                    '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                                    'powers': [1],
                                },
                                {
                                    '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DifferenceEdgeFeature',
                                },
                            ],
                        },
                    },
                    'use_spin': False,
                    'project_to_embedding_dim': False,
                },
                'two_particle_stream_dim': 32,
                'self_interaction': True,
                'edge_features': {
                    'ne': {
                        '_target_': 'deepqmc_tpu_torch.gnn.edge_features.CombinedEdgeFeature',
                        'features': [
                            {
                                '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                                'powers': [1],
                            },
                            {
                                '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DifferenceEdgeFeature',
                            },
                        ],
                    },
                    'same': {
                        '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                        'powers': [1],
                    },
                    'anti': {
                        '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                        'powers': [1],
                    },
                },
                'layer_factory': {
                    '_target_': 'deepqmc_tpu_torch.gnn.electron_gnn.ElectronGNNLayer',
                    '_partial_': True,
                    'subnet_factory': {
                        '_target_': 'deepqmc_tpu_torch.nn.MLP',
                        '_partial_': True,
                        'hidden_layers': ['log', 1],
                        'bias': True,
                        'last_linear': False,
                        'activation': {
                            '_target_': 'deepqmc_tpu_torch.fwdlap.tanh',
                            '_partial_': True,
                        },
                        'init': 'deeperwin',
                    },
                    'nucleus_residual': False,
                    'electron_residual': False,
                    'two_particle_residual': {
                        '_target_': 'deepqmc_tpu_torch.nn.ResidualConnection',
                        'normalize': True,
                    },
                    'deep_features': 'separate',
                    'update_rule': 'concatenate',
                    'update_features': [
                        {
                            '_target_': 'deepqmc_tpu_torch.gnn.update_features.ResidualElectronUpdateFeature',
                            '_partial_': True,
                        },
                        {
                            '_target_': 'deepqmc_tpu_torch.gnn.update_features.NodeSumElectronUpdateFeature',
                            '_partial_': True,
                            'node_types': ['up', 'down'],
                            'normalize': True,
                        },
                        {
                            '_target_': 'deepqmc_tpu_torch.gnn.update_features.ConvolutionElectronUpdateFeature',
                            '_partial_': True,
                            'edge_types': ['ee', 'ne'],
                            'normalize': False,
                            'w_factory': {
                                '_target_': 'deepqmc_tpu_torch.nn.MLP',
                                '_partial_': True,
                                'hidden_layers': ['log', 1],
                                'bias': True,
                                'last_linear': False,
                                'activation': {
                                    '_target_': 'deepqmc_tpu_torch.fwdlap.tanh',
                                    '_partial_': True,
                                },
                                'init': 'deeperwin',
                            },
                            'h_factory': {
                                '_target_': 'deepqmc_tpu_torch.nn.MLP',
                                '_partial_': True,
                                'hidden_layers': ['log', 1],
                                'bias': True,
                                'last_linear': False,
                                'activation': {
                                    '_target_': 'deepqmc_tpu_torch.fwdlap.tanh',
                                    '_partial_': True,
                                },
                                'init': 'deeperwin',
                            },
                            'w_for_ne': False,
                        },
                    ],
                },
            },
        },
    },
    'default': {
        '_target_': 'deepqmc_tpu_torch.wf.NeuralNetworkWaveFunction',
        '_partial_': True,
        'envelope': {
            '_target_': 'deepqmc_tpu_torch.wf.env.ExponentialEnvelopes',
            '_partial_': True,
            'isotropic': True,
            'per_shell': False,
            'per_orbital_exponent': True,
            'spin_restricted': False,
            'init_to_ones': True,
            'softplus_zeta': False,
        },
        'backflow_op': {
            '_target_': 'deepqmc_tpu_torch.wf.nn_wave_function.BackflowOp',
            '_partial_': True,
            'mult_act': '${eval:"lambda x: x"}',
        },
        'n_determinants': 16,
        'full_determinant': True,
        'cusp_electrons': {
            '_target_': 'deepqmc_tpu_torch.wf.cusp.ElectronicCuspAsymptotic',
            '_partial_': True,
            'same_scale': 0.25,
            'anti_scale': 0.5,
            'alpha': 10.0,
            'trainable_alpha': False,
            'cusp_function': {'_target_': 'deepqmc_tpu_torch.wf.cusp.DeepQMCCusp'},
        },
        'cusp_nuclei': False,
        'backflow_transform': 'mult',
        'conf_coeff': {
            '_target_': 'deepqmc_tpu_torch.nn.Linear',
            '_partial_': True,
            'with_bias': False,
            'w_init': {'_target_': 'deepqmc_tpu_torch.nn.ones_init', '_partial_': True},
        },
        'omni_factory': {
            '_target_': 'deepqmc_tpu_torch.wf.omni.OmniNet',
            '_partial_': True,
            'embedding_dim': 128,
            'jastrow_factory': {
                '_target_': 'deepqmc_tpu_torch.wf.omni.Jastrow',
                '_partial_': True,
                'sum_first': True,
                'subnet_factory': {
                    '_target_': 'deepqmc_tpu_torch.nn.MLP',
                    '_partial_': True,
                    'hidden_layers': ['log', 1],
                    'bias': False,
                    'last_linear': True,
                    'activation': None,
                    'init': 'default',
                },
            },
            'backflow_factory': {
                '_target_': 'deepqmc_tpu_torch.wf.omni.Backflow',
                '_partial_': True,
                'subnet_factory': {
                    '_target_': 'deepqmc_tpu_torch.nn.MLP',
                    '_partial_': True,
                    'hidden_layers': ['log', 1],
                    'bias': False,
                    'last_linear': True,
                    'activation': None,
                    'init': 'default',
                },
            },
            'gnn_factory': {
                '_target_': 'deepqmc_tpu_torch.gnn.ElectronGNN',
                '_partial_': True,
                'n_interactions': 3,
                'nuclei_embedding': None,
                'electron_embedding': {
                    '_target_': 'deepqmc_tpu_torch.gnn.electron_gnn.ElectronEmbedding',
                    '_partial_': True,
                    'positional_embeddings': {
                        'ne': {
                            '_target_': 'deepqmc_tpu_torch.gnn.edge_features.CombinedEdgeFeature',
                            'features': [
                                {
                                    '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                                    'powers': [1],
                                },
                                {
                                    '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DifferenceEdgeFeature',
                                },
                            ],
                        },
                    },
                    'use_spin': False,
                    'project_to_embedding_dim': False,
                },
                'two_particle_stream_dim': 32,
                'self_interaction': False,
                'edge_features': {
                    'same': {
                        '_target_': 'deepqmc_tpu_torch.gnn.edge_features.CombinedEdgeFeature',
                        'features': [
                            {
                                '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                                'powers': [1],
                            },
                            {
                                '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DifferenceEdgeFeature',
                            },
                        ],
                    },
                    'anti': {
                        '_target_': 'deepqmc_tpu_torch.gnn.edge_features.CombinedEdgeFeature',
                        'features': [
                            {
                                '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                                'powers': [1],
                            },
                            {
                                '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DifferenceEdgeFeature',
                            },
                        ],
                    },
                },
                'layer_factory': {
                    '_target_': 'deepqmc_tpu_torch.gnn.electron_gnn.ElectronGNNLayer',
                    '_partial_': True,
                    'subnet_factory': {
                        '_target_': 'deepqmc_tpu_torch.nn.MLP',
                        '_partial_': True,
                        'hidden_layers': ['log', 2],
                        'bias': True,
                        'last_linear': False,
                        'activation': {
                            '_target_': 'deepqmc_tpu_torch.fwdlap.tanh',
                            '_partial_': True,
                        },
                        'init': 'default',
                    },
                    'subnet_factory_by_lbl': {
                        'g': {
                            '_target_': 'deepqmc_tpu_torch.nn.MLP',
                            '_partial_': True,
                            'hidden_layers': ['log', 1],
                            'bias': False,
                            'last_linear': False,
                            'activation': {
                                '_target_': 'deepqmc_tpu_torch.fwdlap.tanh',
                                '_partial_': True,
                            },
                            'init': 'default',
                        },
                    },
                    'electron_residual': {
                        '_target_': 'deepqmc_tpu_torch.nn.ResidualConnection',
                        'normalize': True,
                    },
                    'nucleus_residual': None,
                    'two_particle_residual': {
                        '_target_': 'deepqmc_tpu_torch.nn.ResidualConnection',
                        'normalize': True,
                    },
                    'deep_features': 'shared',
                    'update_rule': 'concatenate',
                    'update_features': [
                        {
                            '_target_': 'deepqmc_tpu_torch.gnn.update_features.ResidualElectronUpdateFeature',
                            '_partial_': True,
                        },
                        {
                            '_target_': 'deepqmc_tpu_torch.gnn.update_features.NodeSumElectronUpdateFeature',
                            '_partial_': True,
                            'node_types': ['up', 'down'],
                            'normalize': True,
                        },
                        {
                            '_target_': 'deepqmc_tpu_torch.gnn.update_features.ConvolutionElectronUpdateFeature',
                            '_partial_': True,
                            'edge_types': ['same', 'anti'],
                            'normalize': False,
                            'w_factory': {
                                '_target_': 'deepqmc_tpu_torch.nn.MLP',
                                '_partial_': True,
                                'hidden_layers': ['log', 2],
                                'bias': True,
                                'last_linear': False,
                                'activation': {
                                    '_target_': 'deepqmc_tpu_torch.fwdlap.tanh',
                                    '_partial_': True,
                                },
                                'init': 'default',
                            },
                            'h_factory': {
                                '_target_': 'deepqmc_tpu_torch.nn.MLP',
                                '_partial_': True,
                                'hidden_layers': ['log', 2],
                                'bias': True,
                                'last_linear': False,
                                'activation': {
                                    '_target_': 'deepqmc_tpu_torch.fwdlap.tanh',
                                    '_partial_': True,
                                },
                                'init': 'default',
                            },
                        },
                    ],
                },
            },
        },
    },
    'ferminet': {
        '_target_': 'deepqmc_tpu_torch.wf.NeuralNetworkWaveFunction',
        '_partial_': True,
        'envelope': {
            '_target_': 'deepqmc_tpu_torch.wf.env.ExponentialEnvelopes',
            '_partial_': True,
            'isotropic': True,
            'per_shell': False,
            'per_orbital_exponent': True,
            'spin_restricted': False,
            'init_to_ones': True,
            'softplus_zeta': False,
        },
        'backflow_op': {
            '_target_': 'deepqmc_tpu_torch.wf.nn_wave_function.BackflowOp',
            '_partial_': True,
            'mult_act': '${eval:"lambda x: x"}',
        },
        'n_determinants': 16,
        'full_determinant': True,
        'cusp_electrons': False,
        'cusp_nuclei': False,
        'backflow_transform': 'mult',
        'conf_coeff': {'_target_': 'deepqmc_tpu_torch.nn.SumPool', '_partial_': True},
        'omni_factory': {
            '_target_': 'deepqmc_tpu_torch.wf.omni.OmniNet',
            '_partial_': True,
            'embedding_dim': 256,
            'jastrow_factory': None,
            'backflow_factory': {
                '_target_': 'deepqmc_tpu_torch.wf.omni.Backflow',
                '_partial_': True,
                'subnet_factory': {
                    '_target_': 'deepqmc_tpu_torch.nn.MLP',
                    '_partial_': True,
                    'hidden_layers': ['log', 1],
                    'bias': False,
                    'last_linear': True,
                    'activation': None,
                    'init': 'ferminet',
                },
            },
            'nuclear_gnn_head': None,
            'gnn_factory': {
                '_target_': 'deepqmc_tpu_torch.gnn.ElectronGNN',
                '_partial_': True,
                'n_interactions': 4,
                'electron_embedding': {
                    '_target_': 'deepqmc_tpu_torch.gnn.electron_gnn.ElectronEmbedding',
                    '_partial_': True,
                    'positional_embeddings': {
                        'ne': {
                            '_target_': 'deepqmc_tpu_torch.gnn.edge_features.CombinedEdgeFeature',
                            'features': [
                                {
                                    '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                                    'powers': [1],
                                },
                                {
                                    '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DifferenceEdgeFeature',
                                },
                            ],
                        },
                    },
                    'use_spin': False,
                    'project_to_embedding_dim': False,
                },
                'nuclei_embedding': None,
                'two_particle_stream_dim': 32,
                'self_interaction': True,
                'edge_features': {
                    'up': {
                        '_target_': 'deepqmc_tpu_torch.gnn.edge_features.CombinedEdgeFeature',
                        'features': [
                            {
                                '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                                'powers': [1],
                            },
                            {
                                '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DifferenceEdgeFeature',
                            },
                        ],
                    },
                    'down': {
                        '_target_': 'deepqmc_tpu_torch.gnn.edge_features.CombinedEdgeFeature',
                        'features': [
                            {
                                '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                                'powers': [1],
                            },
                            {
                                '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DifferenceEdgeFeature',
                            },
                        ],
                    },
                },
                'layer_factory': {
                    '_target_': 'deepqmc_tpu_torch.gnn.electron_gnn.ElectronGNNLayer',
                    '_partial_': True,
                    'subnet_factory': {
                        '_target_': 'deepqmc_tpu_torch.nn.MLP',
                        '_partial_': True,
                        'hidden_layers': ['log', 1],
                        'bias': True,
                        'last_linear': False,
                        'activation': {
                            '_target_': 'deepqmc_tpu_torch.fwdlap.tanh',
                            '_partial_': True,
                        },
                        'init': 'ferminet',
                    },
                    'nucleus_residual': False,
                    'electron_residual': {
                        '_target_': 'deepqmc_tpu_torch.nn.ResidualConnection',
                        'normalize': True,
                    },
                    'two_particle_residual': {
                        '_target_': 'deepqmc_tpu_torch.nn.ResidualConnection',
                        'normalize': True,
                    },
                    'deep_features': 'shared',
                    'update_rule': 'concatenate',
                    'update_features': [
                        {
                            '_target_': 'deepqmc_tpu_torch.gnn.update_features.ResidualElectronUpdateFeature',
                            '_partial_': True,
                        },
                        {
                            '_target_': 'deepqmc_tpu_torch.gnn.update_features.NodeSumElectronUpdateFeature',
                            '_partial_': True,
                            'node_types': ['up', 'down'],
                            'normalize': True,
                        },
                        {
                            '_target_': 'deepqmc_tpu_torch.gnn.update_features.EdgeSumElectronUpdateFeature',
                            '_partial_': True,
                            'edge_types': ['up', 'down'],
                            'normalize': True,
                        },
                    ],
                },
            },
        },
    },
    'psiformer': {
        '_target_': 'deepqmc_tpu_torch.wf.NeuralNetworkWaveFunction',
        '_partial_': True,
        'envelope': {
            '_target_': 'deepqmc_tpu_torch.wf.env.ExponentialEnvelopes',
            '_partial_': True,
            'isotropic': True,
            'per_shell': False,
            'per_orbital_exponent': True,
            'spin_restricted': False,
            'init_to_ones': True,
            'softplus_zeta': False,
        },
        'backflow_op': {
            '_target_': 'deepqmc_tpu_torch.wf.nn_wave_function.BackflowOp',
            '_partial_': True,
            'mult_act': '${eval:"lambda x: x"}',
        },
        'n_determinants': 16,
        'full_determinant': True,
        'cusp_electrons': {
            '_target_': 'deepqmc_tpu_torch.wf.cusp.ElectronicCuspAsymptotic',
            '_partial_': True,
            'same_scale': 0.25,
            'anti_scale': 0.5,
            'alpha': 1.0,
            'trainable_alpha': True,
            'cusp_function': {'_target_': 'deepqmc_tpu_torch.wf.cusp.PsiformerCusp'},
        },
        'cusp_nuclei': False,
        'backflow_transform': 'mult',
        'conf_coeff': {'_target_': 'deepqmc_tpu_torch.nn.SumPool', '_partial_': True},
        'omni_factory': {
            '_target_': 'deepqmc_tpu_torch.wf.omni.OmniNet',
            '_partial_': True,
            'embedding_dim': 256,
            'jastrow_factory': None,
            'backflow_factory': {
                '_target_': 'deepqmc_tpu_torch.wf.omni.Backflow',
                '_partial_': True,
                'subnet_factory': {
                    '_target_': 'deepqmc_tpu_torch.nn.MLP',
                    '_partial_': True,
                    'hidden_layers': ['log', 1],
                    'bias': False,
                    'last_linear': True,
                    'activation': None,
                    'init': 'ferminet',
                },
            },
            'nuclear_gnn_head': None,
            'gnn_factory': {
                '_target_': 'deepqmc_tpu_torch.gnn.ElectronGNN',
                '_partial_': True,
                'n_interactions': 4,
                'nuclei_embedding': None,
                'electron_embedding': {
                    '_target_': 'deepqmc_tpu_torch.gnn.electron_gnn.ElectronEmbedding',
                    '_partial_': True,
                    'positional_embeddings': {
                        'ne': {
                            '_target_': 'deepqmc_tpu_torch.gnn.edge_features.CombinedEdgeFeature',
                            'features': [
                                {
                                    '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DistancePowerEdgeFeature',
                                    'powers': [1],
                                    'log_rescale': True,
                                },
                                {
                                    '_target_': 'deepqmc_tpu_torch.gnn.edge_features.DifferenceEdgeFeature',
                                    'log_rescale': True,
                                },
                            ],
                        },
                    },
                    'use_spin': True,
                    'project_to_embedding_dim': True,
                },
                'two_particle_stream_dim': 32,
                'self_interaction': True,
                'edge_features': None,
                'layer_factory': {
                    '_target_': 'deepqmc_tpu_torch.gnn.electron_gnn.ElectronGNNLayer',
                    '_partial_': True,
                    'subnet_factory': {'_target_': 'deepqmc_tpu_torch.nn.Identity', '_partial_': True},
                    'electron_residual': False,
                    'nucleus_residual': False,
                    'two_particle_residual': False,
                    'deep_features': False,
                    'update_rule': 'concatenate',
                    'update_features': [
                        {
                            '_target_': 'deepqmc_tpu_torch.gnn.update_features.NodeAttentionElectronUpdateFeature',
                            '_partial_': True,
                            'num_heads': 4,
                            'mlp_factory': {
                                '_target_': 'deepqmc_tpu_torch.nn.MLP',
                                '_partial_': True,
                                'hidden_layers': ['log', 2],
                                'bias': True,
                                'last_linear': False,
                                'activation': {
                                    '_target_': 'deepqmc_tpu_torch.fwdlap.tanh',
                                    '_partial_': True,
                                },
                                'init': 'ferminet',
                            },
                            'attention_residual': {
                                '_target_': 'deepqmc_tpu_torch.nn.ResidualConnection',
                                'normalize': False,
                            },
                            'mlp_residual': {
                                '_target_': 'deepqmc_tpu_torch.nn.ResidualConnection',
                                'normalize': False,
                            },
                        },
                    ],
                },
            },
        },
    },
}
