"""Tests of the benchmark (python -m pytest mdbench/tests): the CPU runs
the harness at small sizes through the program's plain paths; tests
marked `cuda` need a card and skip without one (the fixture decides when
the test runs, never at import)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the test skips without one)")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card is visible")
    return "cuda:0"


def small_cell(name: str, lattice, steps: int, **workload):
    """Cell `name` of BENCHMARK.json at a small lattice and run() length."""
    from mdbench import spec
    cell = spec.cell(name)
    cell.workload = dict(cell.workload, lattice=list(lattice),
                         steps_per_run=steps, **workload)
    return cell
