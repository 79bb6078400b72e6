"""The ``hamil/mol`` group (``deepqmc_tpu/conf/hamil/mol/*.yaml``): the 28 named
geometries of :mod:`..molecule`, each as its YAML file gives it, and
``from_file``."""

from ...molecule import _MOLECULES

OPTIONS = {name: dict(kwargs) for name, kwargs in _MOLECULES.items()}
OPTIONS['from_file'] = {'_target_': 'deepqmc_tpu_torch.molecule.Molecule.from_file', 'file': '???'}
