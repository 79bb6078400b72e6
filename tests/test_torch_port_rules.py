"""Rules the port keeps: no JAX, no JAX package and no YAML on its path, and
no scipy, h5py, tensorboardX or tqdm at import (optional packages, which a
GPU host may lack); entry points run on CUDA unless told otherwise; ``train`` is the
module of the run; small source files; and the main path hands its kernels
operands their input checks accept."""

import ast
import subprocess
import sys
import types
from functools import partial
from pathlib import Path

import pytest
import torch

import deepqmc_tpu_torch as dqt
from deepqmc_tpu_torch.optimizer import AdamOptimizer

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / 'deepqmc_tpu_torch'
FORBIDDEN = {'jax', 'jaxlib', 'deepqmc_tpu', 'yaml'}
PORT_FILES = sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py']
# the command line and the ECPs: no scipy or tqdm either, even inside a function
CLI_AND_ECP = sorted([*(PKG / 'conf').rglob('*.py'), *(PKG / 'ecp').rglob('*.py'),
                      *(PKG / name for name in ('config.py', 'app.py', '__main__.py',
                                                'validate_kwargs.py'))])


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split('.')[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split('.')[0])
    return roots


@pytest.mark.parametrize('path', PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_yaml_imports(path):
    assert not _imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize('path', CLI_AND_ECP, ids=lambda p: str(p.relative_to(ROOT)))
def test_cli_and_ecp_import_no_scipy_or_tqdm(path):
    assert path.exists()
    assert not _imported_roots(path) & (FORBIDDEN | {'scipy', 'tqdm'})


def test_imports_with_jax_and_yaml_blocked():
    modules = sorted(
        '.'.join(p.relative_to(ROOT).with_suffix('').parts).removesuffix('.__init__')
        for p in PKG.rglob('*.py')
    )
    code = (
        'import sys\n'
        'for name in ("jax", "jaxlib", "yaml", "deepqmc_tpu", "scipy", "h5py", "tensorboardX",'
        ' "tqdm"):\n'
        '    sys.modules[name] = None\n'
        f'import importlib\nfor m in {modules!r}:\n    importlib.import_module(m)\n'
    )
    proc = subprocess.run(
        [sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_evaluate_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip('CUDA is present: the default device is valid here')
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2'))
    wf = dqt.psiformer_ansatz(hamil, n_determinants=1, embedding_dim=8, n_interactions=1,
                              num_heads=2)
    sampling = dict(sampler='decorr_langevin', mols=[hamil.mol], max_eq_steps=2,
                    eq_allow_early_stopping=False)
    for entry_point in (dqt.evaluate, dqt.fit.train):
        for kwargs in ({}, sampling):
            with pytest.raises(RuntimeError, match='CUDA'):
                next(entry_point(hamil, wf, n_walkers=4, steps=1, **kwargs))
    from deepqmc_tpu_torch.sampling import RECIPES, initialize_sampling

    factory = partial(initialize_sampling, elec_sampler=RECIPES['decorr_metropolis'])
    for opt in (None, partial(AdamOptimizer)):
        with pytest.raises(RuntimeError, match='CUDA'):
            dqt.train.train(hamil, wf, opt, factory, steps=1, seed=0, electron_batch_size=4)
        with pytest.raises(RuntimeError, match='CUDA'):  # two states from a factory
            dqt.train.train(hamil, partial(dqt.psiformer_ansatz, hamil, n_determinants=1,
                                           embedding_dim=8, n_interactions=1, num_heads=2),
                            opt, factory, steps=1, seed=0, electron_batch_size=4,
                            electronic_states=2)


def test_train_is_the_module_of_the_run():
    """``deepqmc_tpu_torch.train`` is the module (as ``deepqmc_tpu.train``) and
    ``train.train`` the run; the step loop is ``fit.train``."""
    import importlib

    from deepqmc_tpu_torch import fit

    module = importlib.import_module('deepqmc_tpu_torch.train')
    assert dqt.train is module and isinstance(dqt.train, types.ModuleType)
    assert callable(module.train) and module.train.__module__ == 'deepqmc_tpu_torch.train'
    assert fit.train.__module__ == 'deepqmc_tpu_torch.fit' and fit.train is not module.train


def test_source_files_are_small():
    for path in PKG.rglob('*'):
        if path.is_file() and '_build' not in path.parts and '__pycache__' not in path.parts:
            assert path.stat().st_size < 100_000, path


def test_main_path_operands_pass_the_kernel_checks(monkeypatch):
    """A float32 evaluation on the CPU through wrappers that run each kernel's
    input checks before its plain version: the operands the main path builds
    are the ones the CUDA kernels take."""
    from deepqmc_tpu_torch.ops import fl_attention, fl_slogdet

    seen = []

    def attention(*args):
        fl_attention.validate(*args)
        seen.append('fl_attention')
        return fl_attention.mha_core_fl_plain(*args)

    def traces(*args):
        fl_slogdet.validate(*args)
        seen.append('fl_slogdet')
        return fl_slogdet.slogdet_traces_plain(*args)

    monkeypatch.setattr(fl_attention, 'mha_core_fl', attention)
    monkeypatch.setattr(fl_slogdet, 'slogdet_traces', traces)
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2O'))
    wf = dqt.psiformer_ansatz(hamil, n_determinants=2, embedding_dim=32, n_interactions=2,
                              num_heads=2)
    out = list(dqt.evaluate(hamil, wf, n_walkers=8, steps=2, decorr=2, device='cpu'))
    assert seen == (['fl_attention'] * 2 + ['fl_slogdet']) * 2
    for _, state, E_loc, stats in out:
        assert E_loc.dtype == torch.float32 and torch.isfinite(E_loc).all()
        assert state['elec']['r'].shape == (1, 1, 8, 10, 3)  # [molecule, state, walker, ...]
        assert set(stats) >= {'local_energy/mean', 'energy/ewm', 'sampling/acceptance'}


def test_block_path_operands_pass_the_kernel_checks(monkeypatch):
    """As above with ``block_kernel=True``: each layer's operands pass the fused
    block kernel's checks, and the path takes no attention kernel."""
    from deepqmc_tpu_torch.ops import fl_attention, fl_block, fl_slogdet

    seen = []

    def block(*args, **kwargs):
        fl_block.validate(*args, **kwargs)
        seen.append('fl_block')
        return fl_block.psiformer_block_fl_plain(*args, **kwargs)

    def traces(*args):
        fl_slogdet.validate(*args)
        seen.append('fl_slogdet')
        return fl_slogdet.slogdet_traces_plain(*args)

    def attention(*args):
        raise AssertionError('the block path called the attention core')

    monkeypatch.setattr(fl_block, 'psiformer_block_fl', block)
    monkeypatch.setattr(fl_slogdet, 'slogdet_traces', traces)
    monkeypatch.setattr(fl_attention, 'mha_core_fl', attention)
    hamil = dqt.MolecularHamiltonian(mol=dqt.Molecule.from_name('H2O'))
    wf = dqt.psiformer_ansatz(hamil, n_determinants=2, embedding_dim=32, n_interactions=2,
                              num_heads=2, block_kernel=True)
    out = list(dqt.evaluate(hamil, wf, n_walkers=8, steps=2, decorr=2, device='cpu'))
    assert seen == (['fl_block'] * 2 + ['fl_slogdet']) * 2
    for _, _, E_loc, _ in out:
        assert E_loc.dtype == torch.float32 and torch.isfinite(E_loc).all()
