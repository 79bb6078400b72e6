"""The ``hamil`` group (``deepqmc_tpu/conf/hamil/*.yaml``)."""

OPTIONS = {
    'qc': {
        'defaults': ['_self_', {'mol': 'LiH'}],
        '_target_': 'deepqmc_tpu_torch.hamil.MolecularHamiltonian',
        'mol': {'_target_': 'deepqmc_tpu_torch.molecule.Molecule'},
        'laplacian_factory': {
            '_target_': 'deepqmc_tpu_torch.fwdlap.forward_laplacian',
            '_partial_': True,
        },
    },
    'qc_forward_laplacian': {
        'defaults': ['_self_', {'mol': 'LiH'}],
        '_target_': 'deepqmc_tpu_torch.hamil.MolecularHamiltonian',
        'mol': {'_target_': 'deepqmc_tpu_torch.molecule.Molecule'},
        'laplacian_factory': {
            '_target_': 'deepqmc_tpu_torch.fwdlap.forward_laplacian',
            '_partial_': True,
        },
    },
    'qc_loop_laplacian': {
        'defaults': ['_self_', {'mol': 'LiH'}],
        '_target_': 'deepqmc_tpu_torch.hamil.MolecularHamiltonian',
        'mol': {'_target_': 'deepqmc_tpu_torch.molecule.Molecule'},
        'laplacian_factory': {'_target_': 'deepqmc_tpu_torch.physics.loop_laplacian', '_partial_': True},
    },
}
