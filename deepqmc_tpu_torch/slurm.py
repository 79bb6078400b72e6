"""SLURM launcher (counterpart of ``deepqmc_tpu/slurm.py``): render a plain
sbatch script in the work directory and submit it.

Every SLURM task re-runs the same command line, ``python -m
deepqmc_tpu_torch``, with ``DEEPQMC_TPU_MULTIHOST=1``, so each joins the
``torch.distributed`` group (:func:`.parallel.maybe_init_multi_host` reads
``SLURM_PROCID``, ``SLURM_NTASKS`` and ``SLURM_LOCALID``; one task per GPU),
and each process logs into ``training_<process index>/``
(:func:`.train.process_idx_suffix`).  The script is the JAX package's with
the module name changed.

Config surface (``slurm`` section of the composed config, all optional):
nodes, tasks_per_node, partition, account, qos, time, mem, constraint,
gres, cpus_per_task, name, setup (list of shell lines, e.g. environment
activation).
"""

import logging
import os
import shlex
import subprocess
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

__all__ = ['render_sbatch', 'submit']

_DIRECTIVES = {
    'nodes': '--nodes={}',
    'tasks_per_node': '--ntasks-per-node={}',
    'partition': '--partition={}',
    'account': '--account={}',
    'qos': '--qos={}',
    'time': '--time={}',
    'mem': '--mem={}',
    'constraint': '--constraint={}',
    'gres': '--gres={}',
    'cpus_per_task': '--cpus-per-task={}',
}

DEFAULTS = {'nodes': 1, 'tasks_per_node': 1, 'time': '14-00:00:00'}


def render_sbatch(
    workdir: str, overrides: list[str], slurm_cfg: Optional[dict] = None
) -> str:
    """Render the sbatch script text for one training run."""
    cfg = {**DEFAULTS, **(slurm_cfg or {})}
    setup_lines = cfg.pop('setup', None) or []
    job_name = cfg.pop('name', 'deepqmc_tpu')
    unknown = set(cfg) - set(_DIRECTIVES)
    if unknown:
        raise ValueError(f'Unknown slurm options: {sorted(unknown)}')
    directives = [
        f'#SBATCH {_DIRECTIVES[key].format(value)}'
        for key, value in cfg.items()
        if value is not None
    ]
    cli_args = ' '.join(
        shlex.quote(arg) for arg in [*overrides, f'--workdir={workdir}']
    )
    lines = [
        '#!/bin/bash',
        f'#SBATCH --job-name={job_name}',
        f'#SBATCH --output={workdir}/slurm-%j.out',
        *directives,
        '',
        *setup_lines,
        '',
        'export DEEPQMC_TPU_MULTIHOST=1',
        f'srun python -m deepqmc_tpu_torch {cli_args}',
        '',
    ]
    return '\n'.join(lines)


def submit(
    workdir: str,
    overrides: list[str],
    slurm_cfg: Optional[dict] = None,
    dry_run: bool = False,
) -> Optional[str]:
    """Write the sbatch script into the workdir and submit it.

    Returns the job id, or ``None`` on a dry run (script written, not
    submitted).
    """
    workdir = str(Path(workdir).absolute())
    os.makedirs(workdir, exist_ok=True)
    script = render_sbatch(workdir, overrides, slurm_cfg)
    script_path = Path(workdir) / 'launch.sbatch'
    script_path.write_text(script)
    log.info(f'Wrote sbatch script to {script_path}')
    if dry_run:
        return None
    out = subprocess.run(
        ['sbatch', '--parsable', str(script_path)],
        check=True,
        capture_output=True,
        text=True,
    )
    job_id = out.stdout.strip()
    log.info(f'Submitted SLURM job {job_id}')
    return job_id
