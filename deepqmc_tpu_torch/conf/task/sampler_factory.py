"""The ``task/sampler_factory`` group (``deepqmc_tpu/conf/task/sampler_factory/*.yaml``)."""

OPTIONS = {
    'decorr_langevin': {
        '_target_': 'deepqmc_tpu_torch.sampling.initialize_sampling',
        '_partial_': True,
        'elec_sampler': {
            '_target_': 'deepqmc_tpu_torch.sampling.combine_samplers',
            '_partial_': True,
            'samplers': [
                {
                    '_target_': 'deepqmc_tpu_torch.sampling.DecorrSampler',
                    'length': 10,
                },
                {
                    '_target_': 'deepqmc_tpu_torch.sampling.LangevinSampler',
                    '_partial_': True,
                    'tau': 1.0,
                },
            ],
        },
    },
    'decorr_metropolis': {
        '_target_': 'deepqmc_tpu_torch.sampling.initialize_sampling',
        '_partial_': True,
        'elec_sampler': {
            '_target_': 'deepqmc_tpu_torch.sampling.combine_samplers',
            '_partial_': True,
            'samplers': [
                {
                    '_target_': 'deepqmc_tpu_torch.sampling.DecorrSampler',
                    'length': 20,
                },
                {
                    '_target_': 'deepqmc_tpu_torch.sampling.MetropolisSampler',
                    '_partial_': True,
                    'tau': 1.0,
                    'max_age': 20,
                },
            ],
        },
    },
    'decorr_metropolis_ferminet': {
        '_target_': 'deepqmc_tpu_torch.sampling.initialize_sampling',
        '_partial_': True,
        'elec_sampler': {
            '_target_': 'deepqmc_tpu_torch.sampling.combine_samplers',
            '_partial_': True,
            'samplers': [
                {
                    '_target_': 'deepqmc_tpu_torch.sampling.DecorrSampler',
                    'length': 10,
                },
                {
                    '_target_': 'deepqmc_tpu_torch.sampling.MetropolisSampler',
                    '_partial_': True,
                    'tau': 0.02,
                    'target_acceptance': 0.525,
                    'max_age': None,
                },
            ],
        },
    },
    'decorr_metropolis_psiformer': {
        '_target_': 'deepqmc_tpu_torch.sampling.initialize_sampling',
        '_partial_': True,
        'elec_sampler': {
            '_target_': 'deepqmc_tpu_torch.sampling.combine_samplers',
            '_partial_': True,
            'samplers': [
                {
                    '_target_': 'deepqmc_tpu_torch.sampling.DecorrSampler',
                    'length': 30,
                },
                {
                    '_target_': 'deepqmc_tpu_torch.sampling.MetropolisSampler',
                    '_partial_': True,
                    'tau': 1.0,
                    'max_age': None,
                },
            ],
        },
    },
}
