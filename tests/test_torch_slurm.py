"""The port's SLURM launcher and its process-group settings: ``render_sbatch``
gives the JAX package's script with the module name the only difference,
``--slurm-dry`` through ``python -m deepqmc_tpu_torch`` writes the script and
submits nothing, and the SLURM and ``DEEPQMC_TPU_*`` variables map onto the
arguments of ``init_process_group``."""

import subprocess
import sys
from pathlib import Path

import pytest

from deepqmc_tpu.slurm import render_sbatch as jax_render_sbatch
from deepqmc_tpu_torch import parallel
from deepqmc_tpu_torch.slurm import render_sbatch, submit

ROOT = Path(__file__).resolve().parent.parent
CASES = [
    ([], None),
    (['task.steps=5', 'hamil/mol=H2'], {'nodes': 4, 'tasks_per_node': 4, 'partition': 'gpu',
                                        'gres': 'gpu:4', 'time': '2-00:00:00',
                                        'setup': ['module load cuda', 'source env/bin/activate']}),
    (["task.mols.directory='my mols'"], {'account': 'qmc', 'qos': 'long', 'mem': '0',
                                         'constraint': 'h100', 'cpus_per_task': 8,
                                         'name': 'scan'}),
]


@pytest.mark.parametrize('overrides, cfg', CASES)
def test_render_sbatch_is_jax_with_the_ports_module(overrides, cfg):
    want = jax_render_sbatch('/runs/wd', overrides, cfg)
    got = render_sbatch('/runs/wd', overrides, cfg)
    assert got == want.replace('srun python -m deepqmc_tpu ', 'srun python -m deepqmc_tpu_torch ')
    assert 'export DEEPQMC_TPU_MULTIHOST=1' in got


def test_render_refuses_unknown_options():
    with pytest.raises(ValueError, match='Unknown slurm options'):
        render_sbatch('/tmp/wd', [], {'nodez': 2})


def test_submit_dry_run_writes_only(tmp_path):
    assert submit(str(tmp_path), ['task.steps=1'], {'nodes': 2}, dry_run=True) is None
    assert '#SBATCH --nodes=2' in (tmp_path / 'launch.sbatch').read_text()
    assert sorted(p.name for p in tmp_path.iterdir()) == ['launch.sbatch']


def test_cli_slurm_dry(tmp_path):
    """``--slurm-dry`` on the command line: the script in the work directory,
    the overrides passed on to each task, and nothing run or submitted."""
    out = subprocess.run(
        [sys.executable, '-m', 'deepqmc_tpu_torch', 'task.steps=1', 'hamil/mol=H2',
         '+slurm.nodes=2', '+slurm.partition=h100', f'--workdir={tmp_path}', '--slurm-dry'],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    script = (tmp_path / 'launch.sbatch').read_text()
    assert '#SBATCH --nodes=2' in script and '#SBATCH --partition=h100' in script
    assert (f'srun python -m deepqmc_tpu_torch task.steps=1 hamil/mol=H2 +slurm.nodes=2 '
            f'+slurm.partition=h100 --workdir={tmp_path}') in script
    assert sorted(p.name for p in tmp_path.iterdir()) == ['launch.sbatch']


@pytest.mark.parametrize('env, want', [
    ({}, None),
    ({'DEEPQMC_TPU_MULTIHOST': '0', 'SLURM_PROCID': '1', 'SLURM_NTASKS': '2'}, None),
    ({'DEEPQMC_TPU_MULTIHOST': '1', 'SLURM_PROCID': '5', 'SLURM_NTASKS': '8',
      'SLURM_LOCALID': '1', 'SLURM_JOB_NODELIST': 'gpu[03-04]'},
     dict(address='gpu03:29500', world_size=8, rank=5, local_rank=1)),
    ({'DEEPQMC_TPU_MULTIHOST': 'true', 'SLURM_PROCID': '0', 'SLURM_NTASKS': '4',
      'SLURM_JOB_NODELIST': 'node7', 'DEEPQMC_TPU_COORDINATOR_ADDRESS': 'head:1234'},
     dict(address='head:1234', world_size=4, rank=0, local_rank=None)),
    ({'DEEPQMC_TPU_MULTIHOST': '1', 'DEEPQMC_TPU_COORDINATOR_ADDRESS': 'localhost:29400',
      'DEEPQMC_TPU_NUM_PROCESSES': '2', 'DEEPQMC_TPU_PROCESS_ID': '1'},
     dict(address='localhost:29400', world_size=2, rank=1, local_rank=None)),
])
def test_environment_maps_onto_the_process_group(env, want):
    assert parallel.init_args_from_env(env) == want


@pytest.mark.parametrize('rank, local_rank, device_count, want', [
    (1, None, 2, 1),  # two processes on one host, no SLURM: one GPU each
    (5, None, 4, 1),  # rank 5 of two hosts of four: the second GPU of its host
    (3, 3, 4, 3),  # SLURM_LOCALID
    (3, 3, 1, 0),  # SLURM's GPU binding: the task sees its own card only
    (1, None, 1, 0),  # CUDA_VISIBLE_DEVICES of one card a process
])
def test_each_local_rank_takes_its_own_gpu(rank, local_rank, device_count, want):
    assert parallel.local_device(rank, local_rank, device_count) == want


def test_a_local_rank_without_a_gpu_raises():
    with pytest.raises(ValueError, match='no GPU of its own'):
        parallel.local_device(4, 4, 2)
    with pytest.raises(RuntimeError, match='sees none'):
        parallel.local_device(0, None, 0)


def test_two_ranks_on_one_gpu_raise():
    """Each rank publishes its card in the group's store; a card that two
    ranks hold raises on the rank that finds it (NCCL takes one rank a GPU)."""
    import torch.distributed as dist

    store = dist.HashStore()
    store.set('deepqmc_tpu/gpu/1', 'GPU-b')
    parallel.claim_device(store, 0, 2, 'GPU-a')
    store = dist.HashStore()
    store.set('deepqmc_tpu/gpu/1', 'GPU-a')
    with pytest.raises(RuntimeError, match=r'ranks \[0, 1\] share the GPU GPU-a'):
        parallel.claim_device(store, 0, 2, 'GPU-a')


def test_multihost_without_a_coordinator_raises():
    with pytest.raises(ValueError, match='DEEPQMC_TPU_COORDINATOR_ADDRESS'):
        parallel.init_args_from_env({'DEEPQMC_TPU_MULTIHOST': '1'})
    assert parallel.maybe_init_multi_host('cpu', environ={}) is False
