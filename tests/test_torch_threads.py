"""The plain force paths give the same bits at any CPU thread count.

A CPU reduction into one value splits its elements among the OpenMP
threads that join it, so a flat sum of a pair tensor past torch's grain
(32,768 elements) took its bits from the thread count: the step-0 energy
of a 4k run moved by a few ulp between runs. thermo.ordered_sum sums in
fixed blocks instead. Each case calls one plain path on the 4k lattice
(-s 10, float64) at 1, 2, 3 and 8 intra-op threads and asserts that its
forces, energy and virial (and, for the fused step and the temperature,
the velocity sums) are bit-identical across the counts."""

import numpy as np
import pytest
import torch

from minimd_torch import thermo
from minimd_torch.config import builtin_deck
from minimd_torch.ops.eam import make_eam_force
from minimd_torch.ops.eam_grid import make_eam_force_grid
from minimd_torch.ops.eam_half import make_eam_force_half
from minimd_torch.ops.lj_grid import make_lj_force_grid
from minimd_torch.ops.lj_half import make_lj_force_half
from minimd_torch.ops.lj_step import make_lj_step_plain
from minimd_torch.sim import Simulation

THREADS = (1, 2, 3, 8)
F64 = torch.float64


@pytest.fixture(scope="module")
def sims():
    out = {}
    for deck in ("lj", "eam"):
        inp = builtin_deck(deck)
        inp.nx = inp.ny = inp.nz = 10
        out[deck] = Simulation.from_input(inp, dtype=F64, device="cpu")
    return out


def _call(case, sims):
    """() -> the tensors of one call of the case's plain path."""
    if case == "temperature":
        # 150,000 velocity components: past the grain, where the 4k
        # lattice's 18,000 are not
        v = torch.as_tensor(np.random.default_rng(5).normal(
            size=(3, 50_000)))
        scales = sims["lj"].scales
        return lambda: (thermo.temperature(v, 1.0, scales),)
    sim = sims[case.split("_")[0]]
    geom, x, typ = sim.geom, sim.state.x, sim.state.typ
    model = sim.params if sim.tables is None else sim.tables
    if case == "lj_step":
        step, _ = make_lj_step_plain(geom, model, sim.inp.dt, sim.dtforce,
                                     F64, "cpu")
        return lambda: step(x, sim.state.v, True)
    if case == "eam":
        force = make_eam_force(geom, model, F64, "cpu")
    elif case.startswith("lj_half"):
        force = make_lj_force_half(geom, model, F64, "cpu",
                                   ghost_newton=case == "lj_half")[0]
    else:
        make = {"lj_grid": make_lj_force_grid, "eam_grid": make_eam_force_grid,
                "eam_half": make_eam_force_half}[case]
        force = make(geom, model, F64, "cpu")[0]
    return lambda: force(x, typ)


@pytest.mark.parametrize("case", ["lj_grid", "lj_half", "lj_half_gn0",
                                  "lj_step", "eam_grid", "eam", "eam_half",
                                  "temperature"])
def test_plain_sums_do_not_follow_thread_count(sims, case):
    call = _call(case, sims)
    n0 = torch.get_num_threads()
    outs = {}
    try:
        for n in THREADS:
            torch.set_num_threads(n)
            outs[n] = [t.numpy().tobytes() for t in call()]
    finally:
        torch.set_num_threads(n0)
    for n in THREADS[1:]:
        assert outs[n] == outs[1], f"{case}: {n} threads differ from 1"
