"""The harness's verdict with the timed path broken underneath: every run
below is a whole run of a cell (at a small lattice, on the CPU's plain
paths, past the harness's look for a card) and must come out not
correct, where the same run unbroken comes out correct."""

import time

import pytest
import torch

from conftest import small_cell
from mdbench import run


def _run(name="lj_fcc.864k", lattice=(8, 8, 8), devices=("cpu",)):
    cell = small_cell(name, lattice, 20)
    res = run.run_cell(cell, 2 ** 31 + 77, 0, False, list(devices),
                       time.perf_counter(), calls=2)
    return res["correct"], res["numbers"]


def _wrap_forces(monkeypatch, change):
    from minimd_torch.sim import Simulation

    make = Simulation._make_force

    def broken(self, geom, cuda):
        def wrap(fn):
            def call(x, typ):
                f, e, v = fn(x, typ)
                return change(f.clone(), x), e, v
            return call
        return tuple(wrap(fn) for fn in make(self, geom, cuda))

    monkeypatch.setattr(Simulation, "_make_force", broken)


def test_sound_run_is_correct():
    ok, numbers = _run()
    assert ok, numbers


def test_state_left_unchanged(monkeypatch):
    from minimd_torch.sim import Simulation

    steps = Simulation._run

    def frozen(self, *args, **kwargs):
        keep = self.state.clone()
        trace = steps(self, *args, **kwargs)
        self.state = keep
        return trace

    monkeypatch.setattr(Simulation, "_run", frozen)
    ok, numbers = _run()
    assert not ok and numbers["x_gap"] > 1.0


def test_half_the_atoms_left_out(monkeypatch):
    def half(f, x):
        f[:, f.shape[1] // 2:] = 0.0
        return f

    _wrap_forces(monkeypatch, half)
    ok, numbers = _run()
    assert not ok and numbers["force_gap"] > 0.1


def test_one_answer_altered(monkeypatch):
    def nudge(f, x):
        first = int(torch.nonzero(x[0] < 5e5)[0])
        f[0, first] += 1.0
        return f

    _wrap_forces(monkeypatch, nudge)
    ok, numbers = _run()
    assert not ok and numbers["force_gap"] > 0.01


@pytest.mark.parametrize("stale", [False, True], ids=["exchanged", "stale"])
def test_exchange_between_devices_left_out(monkeypatch, stale):
    """The decomposed run (ShardedSimulation, one domain a device) on four
    CPU device groups: with the copies between groups left out after the
    first (each group keeps what it received then), the run is not
    correct."""
    from minimd_torch.parallel.mesh import Router

    if stale:
        pull, first = Router.pull, {}

        def stale_pull(self, flat, sends, dim=0):
            got = pull(self, flat, sends, dim)
            old = first.setdefault(id(sends), got)
            return [torch.cat([o.narrow(dim, 0, f.shape[dim]),
                               s.narrow(dim, f.shape[dim],
                                        o.shape[dim] - f.shape[dim])], dim)
                    if s.shape == o.shape else o
                    for f, o, s in zip(flat, got, old)]

        monkeypatch.setattr(Router, "pull", stale_pull)
    ok, numbers = _run(lattice=(12, 12, 12),
                       devices=[f"cpu:{i}" for i in range(4)])
    assert ok is not stale, numbers
