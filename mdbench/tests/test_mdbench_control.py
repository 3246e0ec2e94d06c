"""The control: the reference itself, computed in bfloat16 (the step below
the configurations' float32), put in the program's place. On three seeds
each cell's control fails its limits where the program passes them; on
the CPU at a small lattice, and (marked cuda) on the card at the cells'
own size, as python -m mdbench.control reads it."""

import time

import pytest

from conftest import small_cell
from mdbench import checks, run, spec

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _readings(cell, seed, devices):
    res = run.run_cell(cell, seed, 0, False, devices, time.perf_counter(),
                       calls=1, control=True)
    return res["correct"], res["control"], res["limits"]


@pytest.mark.parametrize("name", ["lj_fcc.864k", "eam_cu.864k"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_where_the_program_passes(name, seed):
    ok, ctrl, limits = _readings(small_cell(name, (8, 8, 8), 20), seed,
                                 ["cpu"])
    assert ok
    assert not checks.verdict(ctrl, limits), ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lj_fcc.864k", "eam_cu.864k",
                                  "lj_fcc.131k"])
def test_control_fails_at_the_cells_size(cuda_card, name):
    cell = spec.cell(name)
    for seed in SEEDS:
        ok, ctrl, limits = _readings(cell, seed, [cuda_card])
        assert ok
        assert not checks.verdict(ctrl, limits), ctrl
