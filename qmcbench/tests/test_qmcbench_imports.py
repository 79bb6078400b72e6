"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port either (top-level names, whole)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob('*.py') if 'tests' not in p.parts)
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'deepqmc_tpu'}


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split('.')[0])
    return tops


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize('path', sorted((BENCH / 'reference').glob('*.py')),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    tops = imported_tops(path)
    assert not tops & (FORBIDDEN | {'deepqmc_tpu_torch', 'qmcbench'})
    assert tops <= {'math', 'torch', 'numpy'}


def test_names_are_compared_whole():
    """The port's name begins with the JAX package's: it is not forbidden."""
    assert 'deepqmc_tpu_torch' not in FORBIDDEN
    assert 'deepqmc_tpu_torch'.split('.')[0] != 'deepqmc_tpu'
