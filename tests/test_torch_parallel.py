"""Data parallelism over processes on the CPU: a two-process ``gloo`` dry
run, the group formed by ``parallel.maybe_init_multi_host`` from the
``DEEPQMC_TPU_*`` variables, the counterpart of
``__graft_entry__.dryrun_multichip``.

Two ranks (one torch thread each) hold half the walkers each of a molecule
batch of two LiH geometries (the small PsiFormer, float64) and take, with
the same walkers and the same draws as one process:
- the global statistics of ``parallel`` (mean, std, min, max, the median and
  quantiles by linear interpolation, ``pexp_normalize_mean``) against numpy
  on the whole batch;
- two KFAC steps on fixed walkers ``[2, 1, B]``: E_loc, the loss's stats
  and the parameters against one process (the sums reassociated over two
  ranks, relative 1e-11) and against JAX's KFAC step (1e-9), the
  parameters bitwise equal across the ranks;
- a ``fit.train_step`` with Metropolis moves fed each rank its slice of the
  same draws, against one process;
- the initial walkers of ``initialize_sampler_state``: drawn whole, each
  rank's share evaluated on that rank, against one process;
- checkpoints: each rank's shard written into ``training_<rank>`` and read
  back from rank 0's path, and a one-process checkpoint sharded on load;
- the walker divisibility error of ``validate_kwargs`` and ``fit.train``.

Run as a script, this file is one rank: ``python test_torch_parallel.py RANK
WORLD PORT DIR`` (the test starts both).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

B = 8  # walkers a molecule over both ranks
N_STEPS = 2
SCALES = (1.0, 1.15)
REL_RANKS, REL_JAX = 1e-11, 1e-9


def _inputs(hamil_r, seed=0):
    """Walkers ``[step, mol, 1, B, n, 3]``, nuclei ``[mol, n_nuc, 3]``,
    weights ``[mol, 1, B]``, the Metropolis draws of one train step and the
    numbers the statistics test reduces."""
    rng = np.random.default_rng(seed)
    R = np.stack([s * np.asarray(hamil_r) for s in SCALES])
    return {
        'R': R,
        # electrons 0-2 around Li, 3 around H
        'r': R[None, :, None, None, [0, 0, 0, 1]] + 0.7 * rng.normal(
            size=(N_STEPS, 2, 1, B, 4, 3)),
        'weight': rng.uniform(0.5, 1.5, size=(2, 1, B)),
        'noise': rng.normal(size=(2, B, 4, 3)),  # Metropolis: [move, walker, electron, 3]
        'uniform': rng.uniform(size=(2, B)),
        'x': rng.normal(size=(2, 1, B)),
    }


def _port(inputs, state_dict_path, rank=0, world=1):
    """What one rank computes: {name: array}."""
    import torch

    import deepqmc_tpu_torch as dqt
    from deepqmc_tpu_torch import parallel
    from deepqmc_tpu_torch.fit import TrainState, train_step
    from deepqmc_tpu_torch.ewm import init_multi_mol_multi_state_ewm
    from deepqmc_tpu_torch.kfac import KFAC
    from deepqmc_tpu_torch.loss import create_loss_fn, median_log_squeeze_and_mask
    from deepqmc_tpu_torch.optimizer import KFACOptimizer
    from deepqmc_tpu_torch.sampling import (
        DecorrSampler,
        MetropolisSampler,
        chain,
        electron_samplers,
        initialize_sampler_state,
        initialize_sampling,
    )
    from deepqmc_tpu_torch.types import PhysicalConfiguration
    from deepqmc_tpu_torch.utils import ConstantSchedule, InverseSchedule

    def shard(x):
        return parallel.shard_walkers(torch.as_tensor(x))

    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('LiH'))

    def model():
        wf = dqt.psiformer_ansatz(hamil, n_determinants=2, embedding_dim=32, n_interactions=2,
                                  num_heads=2).double()
        wf.load_state_dict(torch.load(state_dict_path, weights_only=True))
        return wf

    out = {}
    x = shard(inputs['x'])
    out['mean'] = parallel.all_device_mean(x, -1)
    out['std'] = parallel.all_device_std(x, -1)
    out['min'] = parallel.all_device_min(x, -1)
    out['max'] = parallel.all_device_max(x, -1)
    out['median'] = torch.stack([parallel.all_device_median(row) for row in x.flatten(0, 1)])
    out['quantile'] = torch.stack([parallel.all_device_quantile(row, 0.95)
                                   for row in x.flatten(0, 1)])
    out['pexp'] = parallel.gather_on_host(parallel.pexp_normalize_mean(x, -1))

    wf = model()
    kwargs = dict(learning_rate_schedule=InverseSchedule(0.05, 10000),
                  damping_schedule=ConstantSchedule(1e-3), norm_constraint=1e-3,
                  inverse_update_period=5)
    kfac = KFAC(create_loss_fn(hamil, wf, median_log_squeeze_and_mask), **kwargs)
    R = torch.tensor(inputs['R'])
    mol_idx = torch.arange(2)[:, None, None].expand(2, 1, B // world).clone()
    weight = shard(inputs['weight'])
    state = None
    for k in range(N_STEPS):
        pc = PhysicalConfiguration(R, shard(inputs['r'][k]), mol_idx)
        state = state or kfac.init(pc)
        state, (E, _, stats), _ = kfac.step(state, pc, weight)
        out[f'E_{k}'] = parallel.gather_on_host(E)
        out.update({f'{key}_{k}': v for key, v in stats.items() if key.startswith('hamil/')})
        out[f'params_{k}'] = torch.cat([p.detach().flatten() for p in wf.parameters()])

    # a train step: Metropolis moves on each rank's walkers with its slice of the draws
    wf = model()

    def draw(values):
        calls = iter(range(10**6))

        def take(*args):
            v = torch.as_tensor(values[next(calls) % len(values)])
            size = v.shape[0] // world
            return v[rank * size:(rank + 1) * size]
        return take

    saved = electron_samplers.normal, electron_samplers.uniform
    electron_samplers.normal = draw(inputs['noise'])
    electron_samplers.uniform = draw(inputs['uniform'])
    try:
        mols = [dqt.Molecule(coords=r, charges=hamil.mol.charges, charge=0, spin=0)
                for r in inputs['R']]
        idx_sampler, sampler = initialize_sampling(
            torch.Generator().manual_seed(0), hamil, wf, mols, 1, 2,
            elec_sampler=lambda hamil, wf: chain(DecorrSampler(length=2), MetropolisSampler(hamil,
                                                                                            wf)))
        with torch.no_grad():
            smpl_state = sampler.update({
                'nuc': {'R': R},
                'elec': {'r': shard(inputs['r'][0]), 'age': shard(np.zeros((2, 1, B), np.int64)),
                         'tau': torch.full((2, 1), 0.5, dtype=torch.float64)},
                'update_nuc_counter': torch.zeros(2, dtype=torch.long),
            })
        opt = KFACOptimizer(create_loss_fn(hamil, wf, median_log_squeeze_and_mask), **kwargs)
        ewm, update_ewm = init_multi_mol_multi_state_ewm((2, 1), dtype=torch.float64)
        train_state = TrainState(smpl_state, None, opt.init(pc))
        train_state, ewm, _, E, _, stats = train_step(None, sampler, opt, train_state,
                                                      torch.tensor([0, 1]), ewm, ewm, update_ewm)
    finally:
        electron_samplers.normal, electron_samplers.uniform = saved
    out['step_E'] = parallel.gather_on_host(E)
    out['step_r'] = parallel.gather_on_host(train_state.sampler['elec']['r'])
    out['step_tau'] = train_state.sampler['elec']['tau']
    out['step_ewm'] = ewm.mean
    out['step_params'] = torch.cat([p.detach().flatten() for p in wf.parameters()])
    out['step_acceptance'] = stats['sampling/acceptance']
    # the initial walkers: drawn whole, each rank's share evaluated on that rank
    with torch.no_grad():
        init = initialize_sampler_state(torch.Generator().manual_seed(3), sampler, B, mols,
                                        dtype=torch.float64)
    out['init_r'] = parallel.gather_on_host(init['elec']['r'])
    out['init_psi'] = parallel.gather_on_host(init['elec']['psi'].log)
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _worker(rank, world, port, workdir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import deepqmc_tpu_torch as dqt
    from deepqmc_tpu_torch import fit, parallel, validate_kwargs

    assert parallel.maybe_init_multi_host('cpu', environ={
        'DEEPQMC_TPU_MULTIHOST': '1', 'DEEPQMC_TPU_COORDINATOR_ADDRESS': f'127.0.0.1:{port}',
        'DEEPQMC_TPU_NUM_PROCESSES': str(world), 'DEEPQMC_TPU_PROCESS_ID': str(rank)})
    assert (dist.get_backend(), dist.get_world_size(), dist.get_rank()) == ('gloo', world, rank)

    inputs = dict(np.load(Path(workdir) / 'inputs.npz'))
    out = _port(inputs, Path(workdir) / 'params.pt', rank, world)
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    wf = dqt.psiformer_ansatz(hamil, n_determinants=1, embedding_dim=8, n_interactions=1,
                              num_heads=1)
    # checkpoints: each rank writes its shard and reads its own from any rank's
    # path; a one-process checkpoint is sharded on load
    from deepqmc_tpu_torch.fit import TrainState
    from deepqmc_tpu_torch.log import CheckpointStore
    from deepqmc_tpu_torch.parallel import shard_walkers

    mine = {'nuc': {'R': torch.tensor(inputs['R'])},
            'elec': {'r': shard_walkers(torch.tensor(inputs['r'][0]))},
            'update_nuc_counter': torch.zeros(2, dtype=torch.long)}
    (Path(workdir) / f'training_{rank}').mkdir()
    CheckpointStore(Path(workdir) / f'training_{rank}').update(3, TrainState(mine, {}, None))
    dist.barrier()
    _, got = CheckpointStore.load(Path(workdir) / 'training_0' / 'chkpt-3.pt')
    _, one = CheckpointStore.load(Path(workdir) / 'one' / 'chkpt-0.pt')
    out['chkpt_own'] = np.array(torch.equal(got.sampler['elec']['r'], mine['elec']['r']))
    out['chkpt_resharded'] = np.array(torch.equal(one.sampler['elec']['r'], mine['elec']['r']))
    errors = []
    for call in (lambda: validate_kwargs.validate_kwargs({'electron_batch_size': 7}),
                 lambda: next(fit.train(hamil, wf, n_walkers=7, device='cpu'))):
        try:
            call()
        except ValueError as e:
            errors.append(str(e))
    out['errors'] = np.array(errors)
    np.savez(Path(workdir) / f'rank{rank}.npz', **out)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_one_process_and_jax(tmp_path):
    import jax
    import torch
    from torch_parity import assert_close, jax_model, torch_model

    from deepqmc_tpu.kfac import KFAC as JaxKFAC
    from deepqmc_tpu.loss import create_loss_fn as jax_create_loss_fn
    from deepqmc_tpu.loss import median_log_squeeze_and_mask as jax_clip
    from deepqmc_tpu.types import PhysicalConfiguration as JaxConf
    from deepqmc_tpu.utils import ConstantSchedule as JaxConstant
    from deepqmc_tpu.utils import InverseSchedule as JaxInverse

    hamil_j, ansatz, params = jax_model('LiH', seed=0)
    _, wf = torch_model('LiH', params)
    torch.save(wf.state_dict(), tmp_path / 'params.pt')
    inputs = _inputs(hamil_j.mol.coords)
    np.savez(tmp_path / 'inputs.npz', **inputs)
    from deepqmc_tpu_torch.fit import TrainState
    from deepqmc_tpu_torch.log import CheckpointStore

    (tmp_path / 'one').mkdir()
    CheckpointStore(tmp_path / 'one').update(0, TrainState(
        {'nuc': {'R': torch.tensor(inputs['R'])}, 'elec': {'r': torch.tensor(inputs['r'][0])},
         'update_nuc_counter': torch.zeros(2, dtype=torch.long)}, {}, None))
    port = _free_port()
    env = {**os.environ, 'OMP_NUM_THREADS': '1',
           'PYTHONPATH': os.pathsep.join([str(Path(__file__).parent.parent),
                                          os.environ.get('PYTHONPATH', '')])}
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), '2', str(port),
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    one = _port(inputs, tmp_path / 'params.pt')  # one process meanwhile
    for proc in procs:
        log, _ = proc.communicate(timeout=240)
        assert proc.returncode == 0, log[-3000:]
    ranks = [dict(np.load(tmp_path / f'rank{r}.npz')) for r in range(2)]

    # the statistics against numpy on the whole batch
    x = inputs['x']
    want = {'mean': x.mean(-1), 'std': x.std(-1), 'min': x.min(-1), 'max': x.max(-1),
            'median': np.median(x, -1).reshape(-1), 'quantile': np.quantile(x, 0.95,
                                                                            -1).reshape(-1)}
    w = np.exp(x - x.max(-1, keepdims=True))
    want['pexp'] = w / w.mean(-1, keepdims=True)
    for rank in ranks:
        for key, value in want.items():
            assert_close(rank[key], value, 1e-14, key)

    # the ranks agree bitwise; with one process to reassociation
    for key, value in one.items():
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
        assert_close(ranks[0][key], value, REL_RANKS, f'two ranks against one: {key}')
    assert not np.array_equal(ranks[0]['step_r'], inputs['r'][0])  # the walkers moved

    # the first KFAC step against JAX's
    kfac_j = JaxKFAC(jax_create_loss_fn(hamil_j, ansatz, jax_clip).value_and_grad,
                     learning_rate_schedule=JaxInverse(0.05, 10000),
                     damping_schedule=JaxConstant(1e-3), norm_constraint=1e-3,
                     inverse_update_period=5)
    kfac_j.bind_ansatz(ansatz)
    R = np.broadcast_to(inputs['R'][:, None, None], (2, 1, B, *inputs['R'].shape[1:]))
    batch = (JaxConf(R, inputs['r'][0], np.zeros((2, 1, B), np.int32)), inputs['weight'], {})
    rng = jax.random.PRNGKey(0)
    (params_j,), _, (E_j, _, _), _ = jax.jit(kfac_j.step)(
        rng, [params], kfac_j.init(rng, [params], batch), batch)
    assert_close(ranks[0]['E_0'], E_j, REL_JAX, 'E_loc against JAX')
    want_params = torch_model('LiH', jax.device_get(params_j))[1]
    assert_close(ranks[0]['params_0'],
                 torch.cat([p.detach().flatten() for p in want_params.parameters()]),
                 REL_JAX, 'parameters after a KFAC step against JAX')

    for rank in ranks:
        assert rank['chkpt_own'] and rank['chkpt_resharded']
    errors = list(ranks[0]['errors'])
    assert len(errors) == 2
    assert 'Electron batch size (7) cannot be evenly split across 2 devices' in errors[0]
    assert 'Electron batch size (7) cannot be evenly split across 2 processes' in errors[1]


if __name__ == '__main__':
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
