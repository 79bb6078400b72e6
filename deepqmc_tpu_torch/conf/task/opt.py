"""The ``task/opt`` group (``deepqmc_tpu/conf/task/opt/*.yaml``)."""

OPTIONS = {
    'adamw': {
        '_target_': 'deepqmc_tpu_torch.optimizer.OptaxOptimizer',
        '_partial_': True,
        'optax_opt': {
            '_target_': 'deepqmc_tpu_torch.optimizer.adamw',
            'learning_rate': 0.001,
            'b2': 0.9,
        },
    },
    'kfac': {
        '_target_': 'deepqmc_tpu_torch.optimizer.KFACOptimizer',
        '_partial_': True,
        'kfac': {
            '_target_': 'deepqmc_tpu_torch.kfac.KFAC',
            '_partial_': True,
            'learning_rate_schedule': {
                '_target_': 'deepqmc_tpu_torch.utils.InverseSchedule',
                'init_value': 0.05,
                'decay_rate': 10000,
            },
            'norm_constraint': 0.001,
            'damping_schedule': {'_target_': 'deepqmc_tpu_torch.utils.ConstantSchedule', 'value': 0.001},
            'estimation_mode': 'fisher_exact',
            'num_burnin_steps': 0,
            'inverse_update_period': 5,
        },
    },
    'kfac_psiformer': {
        '_target_': 'deepqmc_tpu_torch.optimizer.KFACOptimizer',
        '_partial_': True,
        'kfac': {
            '_target_': 'deepqmc_tpu_torch.kfac.KFAC',
            '_partial_': True,
            'learning_rate_schedule': {
                '_target_': 'deepqmc_tpu_torch.utils.InverseSchedule',
                'init_value': 0.05,
                'decay_rate': 100000,
            },
            'norm_constraint': 0.001,
            'damping_schedule': {'_target_': 'deepqmc_tpu_torch.utils.ConstantSchedule', 'value': 0.001},
            'estimation_mode': 'fisher_exact',
            'num_burnin_steps': 0,
            'inverse_update_period': 5,
        },
    },
}
