"""The JAX package's configuration tree (``deepqmc_tpu/conf/``) as Python data:
one dict per YAML file, under the same group names, with each ``_target_``
naming the port's object (:func:`..config.port_target`).  The ``${...}``
interpolations and ``${eval:"..."}`` strings stay as in the YAML.
``config.compose`` reads it."""

from . import ansatz, hamil, task
from .hamil import mol
from .task import opt, sampler_factory

CONFIG = {
    'defaults': ['_self_', {'task': 'train'}, {'ansatz': 'default'}, {'hamil': 'qc'}],
    'task': {'workdir': '???'},
    'logging': {'deepqmc_tpu': 10, 'jax': 40},
}

# the root configs and the groups, by the paths of deepqmc_tpu/conf/
ROOTS = {'config': CONFIG}
GROUPS = {
    'task': task.OPTIONS,
    'task/opt': opt.OPTIONS,
    'task/sampler_factory': sampler_factory.OPTIONS,
    'ansatz': ansatz.OPTIONS,
    'hamil': hamil.OPTIONS,
    'hamil/mol': mol.OPTIONS,
}
