"""Shared fixtures of the benchmark's own tests.

CPU tests run the harness at a tiny size with the port's plain kernels;
tests marked ``cuda`` need the card and skip here (decided in the ``card``
fixture, never at import)."""
import time

import pytest
import torch

CELLS = ("os2015_tri_affine.sweep_b256", "os2015_tri_stencil.sweep_b1024")
# 2 x 2 subdomains of 2 x 2 cells: K = 4, N = 24
TINY_GRID = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
             "num_refinements": 1}


def tiny(cell: str) -> dict:
    """Overrides that shrink a cell to a CPU test: the tiny grid, 4 queries a
    call; the stencil form asked for explicitly (the step takes it only at
    >= 16 384 dofs by default)."""
    ov = {"config": {"grid": dict(TINY_GRID)},
          "traffic": {"batch": 4, "warmup_calls": 1, "trace_calls": 2, "gap_calls": 1}}
    if "stencil" in cell:
        ov["config"]["program"] = {"step": {"matrix_free": True}}
    return ov


def run_tiny(cell, seed=2 ** 31 + 17, seconds=0.5, trace=False):
    from benchmark import harness
    torch.set_num_threads(2)
    return harness.run(cell, seed, seconds, trace, "cpu", time.perf_counter(), tiny(cell))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures only on the card")
    return torch.device("cuda:0")
