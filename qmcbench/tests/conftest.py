"""Shared pieces of the benchmark's tests: the marker of the tests that need
the card, and the cells cut to a width the CPU runs in seconds."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line('markers', 'chip: needs a CUDA card; skips elsewhere')
    import torch

    torch.set_num_threads(2)  # the tests run several workers


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return 'cuda'


def tiny_spec(workload, **traffic_overrides):
    """A cell's files with the widths, walkers and steps cut for the CPU."""
    from qmcbench import harness

    cell, cfg, traffic, limits = harness.cell_spec(workload)
    cfg = dict(cfg, embedding_dim=16, n_interactions=2, n_determinants=2, max_eq_steps=2)
    if cfg['ansatz'] == 'psiformer':
        cfg['num_heads'] = 2
    else:
        cfg['two_particle_stream_dim'] = 8
    traffic = dict(traffic, walkers=32, trace_steps=1, **traffic_overrides)
    if traffic['optimizer'] is None:  # every answer of the window checked
        traffic.update(rows_per_step=32, check_rows=10**6, warmup_steps=1)
    else:
        traffic.update(check_rows=32)
    return cell, cfg, traffic, limits
