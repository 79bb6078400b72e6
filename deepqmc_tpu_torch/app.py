"""Command line of the port (counterpart of ``deepqmc_tpu/app.py``).

    python -m deepqmc_tpu_torch [--workdir=DIR] [--device=cuda|cpu] [--slurm|--slurm-dry]
                                [overrides...]

The overrides compose the port's configuration tree (:mod:`.conf`, the JAX
package's ``conf/`` as Python data) with the grammar of the JAX command
line: ``key.sub=value``, ``group=option``, ``group/sub=option``,
``+new.key=value``, ``~key``.  The task runs in the working directory
(``--workdir``, else the current one), which gets ``deepqmc.log`` and the
composed config as ``.hydra/config.json``; ``task=restart``,
``task=evaluate``, ``task=evaluate_excited`` and ``task=evaluate_forces``
read that file and the last checkpoint of ``task.restdir``.  The run is on the GPU unless
``--device=cpu``; without a GPU the default raises.

Several processes, one per GPU, run one training with the walkers sharded
(:mod:`.parallel`) when started with ``DEEPQMC_TPU_MULTIHOST=1`` and either
``DEEPQMC_TPU_COORDINATOR_ADDRESS`` (host:port), ``DEEPQMC_TPU_NUM_PROCESSES``
and ``DEEPQMC_TPU_PROCESS_ID``, or as SLURM tasks.  ``--slurm`` writes an
sbatch script into the working directory that does that and submits it;
``--slurm-dry`` only writes it (:mod:`.slurm`).

Where the card's machine lacks tensorboardX or h5py, turn their sinks off:
``task.metric_logger_constructor=null task.h5_logger_constructor=null``
(in this command line, a null sink constructor means no such sink), and for
``task=evaluate_forces`` ``task.h5_logger=null``.
"""

import json
import logging
import os
import platform
import sys
from functools import partial
from pathlib import Path
from typing import Optional, Union

from .config import compose, instantiate
from .molecule import Molecule, read_molecule_dataset
from .parallel import get_process_count, get_process_index, maybe_init_multi_host
from .utils import resolve_device
from .validate_kwargs import validate_kwargs

__all__ = ['cli', 'main', 'read_molecules', 'train_from_checkpoint', 'train_from_factories']

log = logging.getLogger(__name__)
PACKAGE_LOGGER = logging.getLogger('deepqmc_tpu_torch')
CONFIG_PATH = Path('.hydra') / 'config.json'
# sink constructors a task may set to null to write no such output
SINK_KEYS = ('metric_logger_constructor', 'h5_logger_constructor')
_HANDLERS: list = []


def read_molecules(directory: Union[Path, str, None] = None,
                   whitelist: Optional[str] = None) -> Optional[list[Molecule]]:
    """The molecules of a directory of molecule files, or None without one."""
    if directory is None:
        return None
    path = Path(directory).absolute()
    log.info(f'Reading molecules from {path}')
    molecules = read_molecule_dataset(path, whitelist)
    log.info(f'Read {len(molecules)} molecules: {", ".join(molecules)}')
    if not molecules:
        raise ValueError(f'No molecules found in {path} with whitelist {whitelist!r}.')
    return list(molecules.values())


def train_from_factories(hamil, ansatz, **kwargs):
    """``train.train`` with the ansatz factory ``(hamil, gen=...) -> module``
    of the config bound to ``hamil``; a null sink constructor is no sink."""
    from .log import no_sink
    from .train import train

    for key in SINK_KEYS:
        if key in kwargs and kwargs[key] is None:
            kwargs[key] = no_sink
    return train(hamil, partial(ansatz, hamil), **kwargs)


def assert_valid_restdir(restdir: Path, workdir: str):
    if not restdir.is_dir():
        raise ValueError(f'restdir {str(restdir)!r} is not a directory')
    if str(restdir.parent) == str(workdir):
        raise ValueError('Cannot restore from the directory you are running in; choose a '
                         'different workdir.')


def task_from_workdir(workdir, chkpt, device=None):
    """The composed config of the run in ``workdir`` (or its parent) and its
    checkpoint ``chkpt`` ('LAST': the latest, in ``workdir`` or
    ``workdir/training``) as ``(cfg, step, train_state)``."""
    from .log import CheckpointStore

    workdir = Path(workdir)
    if not workdir.is_dir():
        raise ValueError(f'{workdir} is not a directory')
    cfg_path = workdir / CONFIG_PATH
    if not cfg_path.exists():
        cfg_path = workdir.parent / CONFIG_PATH
    cfg = json.loads(cfg_path.read_text())
    if chkpt == 'LAST':
        chkpts = list(workdir.glob(CheckpointStore.PATTERN.format('*')))
        for sub in ('training', 'training_0'):  # one process's run, or rank 0's of several
            if not chkpts:
                chkpts = list((workdir / sub).glob(CheckpointStore.PATTERN.format('*')))
        if not chkpts:
            raise ValueError(f'no checkpoint in {workdir}')
        chkpt = sorted(chkpts,
                       key=lambda p: CheckpointStore.extract_step_from_filename(p.name))[-1]
    else:
        chkpt = workdir / chkpt
    step, train_state = CheckpointStore.load(chkpt, device)
    return cfg, step, train_state


def train_from_checkpoint(workdir, restdir, evaluate, chkpt='LAST', device=None, **kwargs):
    """Restart (``evaluate=False``, from the checkpoint's step) or evaluate
    (``opt=None``) the run whose workdir is ``restdir``, with its own config;
    ``kwargs`` (``steps``, ``observable_monitors``, ...) go to ``train``.
    ``h5_logger`` (``task=evaluate_forces``'s HDF5 sink with its whitelist)
    stands for ``train``'s ``h5_logger_constructor``, null for none: the JAX
    package's ``train`` takes no ``h5_logger`` and raises on that task's key."""
    if 'h5_logger' in kwargs:
        kwargs['h5_logger_constructor'] = kwargs.pop('h5_logger')
    restdir = Path(restdir).absolute()
    assert_valid_restdir(restdir, workdir)
    cfg, step, train_state = task_from_workdir(restdir, chkpt, resolve_device(device))
    while cfg['task'].get('restdir', False):
        restdir = Path(cfg['task']['restdir']).absolute()
        assert_valid_restdir(restdir, workdir)
        cfg, *_ = task_from_workdir(restdir, 'LAST', 'cpu')
    log.info(f'Found original config file in {restdir}')
    cfg['task']['workdir'] = str(workdir)
    if not kwargs.pop('keep_sampler_state', not evaluate):
        train_state = train_state._replace(sampler=None)
    if evaluate:
        cfg['task']['opt'] = None
        train_state = train_state._replace(opt=None)
    else:
        cfg['task']['init_step'] = step
    return instantiate(cfg['task'], root=cfg, train_state=train_state, device=device, **kwargs)


def teardown_logging():
    """Detach the handlers :func:`setup_logging` attached."""
    for handler in _HANDLERS:
        PACKAGE_LOGGER.removeHandler(handler)
        handler.close()
    _HANDLERS.clear()


def setup_logging(cfg, workdir: str):
    """The package's log to stderr and to ``workdir/deepqmc.log``, at the
    config's level (``logging.deepqmc_tpu``, as in the JAX tree)."""
    fmt = logging.Formatter('[%(asctime)s] %(levelname)s:%(name)s: %(message)s')
    teardown_logging()
    for handler in (logging.StreamHandler(sys.stderr),
                    logging.FileHandler(os.path.join(workdir, 'deepqmc.log'), mode='a')):
        handler.setFormatter(fmt)
        PACKAGE_LOGGER.addHandler(handler)
        _HANDLERS.append(handler)
    PACKAGE_LOGGER.setLevel((cfg.get('logging') or {}).get('deepqmc_tpu', logging.INFO))


def detect_devices(device):
    """Log this process's host and the devices and processes of the run."""
    import torch

    n_process = get_process_count()
    kind = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'the CPU'
    log.info(f'Process {get_process_index()} running on {platform.node()}')
    log.info(f'Running on {kind} with {n_process} process{"" if n_process == 1 else "es"}')


def main(cfg: dict, workdir: Optional[str] = None, device=None):
    """Run the composed config's task in ``workdir`` on ``device`` (None:
    CUDA), as one process of several where the environment asks for that
    (:func:`.parallel.maybe_init_multi_host`)."""
    device = resolve_device(device)
    maybe_init_multi_host(device)
    if device.type == 'cuda':
        import torch

        device = torch.device('cuda', torch.cuda.current_device())
    workdir = workdir or cfg['task'].get('workdir')
    if not workdir or workdir == '???':
        workdir = str(Path.cwd())
    workdir = str(Path(workdir).absolute())
    cfg['task']['workdir'] = workdir
    os.makedirs(workdir, exist_ok=True)
    setup_logging(cfg, workdir)
    log.info('Entering application')
    detect_devices(device)
    log.info(f'Will work in {workdir}')
    path = Path(workdir) / CONFIG_PATH
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(cfg, indent=1))
    validate_kwargs(cfg['task'])
    return instantiate(cfg['task'], root=cfg, device=device)


def cli(argv: Optional[list[str]] = None):
    """Entry point: ``python -m deepqmc_tpu_torch key=value group=option ...``."""
    argv = sys.argv[1:] if argv is None else argv
    workdir, device, overrides, slurm_mode = None, 'cuda', [], None
    for arg in argv:
        if arg.startswith('--workdir='):
            workdir = arg.split('=', 1)[1]
        elif arg.startswith('--device='):
            device = arg.split('=', 1)[1]
        elif arg in ('--slurm', '--slurm-dry'):
            # submit (or only write, with --slurm-dry) this run as a SLURM batch job
            slurm_mode = arg
        elif arg.startswith('--platform='):
            raise ValueError(f'{arg}: the port takes --device=cuda or --device=cpu')
        elif arg in ('-h', '--help'):
            print(__doc__)
            return None
        else:
            overrides.append(arg)
    cfg = compose(overrides=overrides)
    if slurm_mode:
        from .slurm import submit

        logging.basicConfig(level=logging.INFO)
        workdir = workdir or cfg['task'].get('workdir')
        if not workdir or workdir == '???':
            workdir = str(Path.cwd())
        return submit(workdir, overrides, cfg.get('slurm'), dry_run=slurm_mode == '--slurm-dry')
    try:
        return main(cfg, workdir=workdir, device=device)
    except KeyboardInterrupt:
        log.warning('Interrupted!')
        return None
    finally:
        teardown_logging()
