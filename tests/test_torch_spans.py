"""The program's spans (minimd_torch/timer.py) on the CPU: their names,
counts and nesting in run() of the one-device LJ and EAM paths and of a
two-domain decomposed run; no span entered and no clock read while no
profiler records, with the same rows bit for bit; the set-up record's
parts.

The counts are taken by a recording `timer.span` with `timer.recording`
patched true (the CPU profiler records every aten op, which would make
a run of 40 plain steps take tens of seconds); one short run under
torch.profiler checks that the real ranges are the same."""

import collections
import contextlib
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from minimd_torch import create, timer
from minimd_torch.config import builtin_deck
from minimd_torch.parallel import ShardedSimulation
from minimd_torch.sim import Simulation

torch.set_num_threads(2)

SETUP = ("geometry", "upload", "tables", "kernels", "first_force")


def _deck(name, s=4, nstat=20, every=20):
    inp = builtin_deck(name)
    inp.nx = inp.ny = inp.nz = s
    inp.thermo_nstat = nstat
    inp.neigh_every = every
    return inp


class Recorder:
    """A span helper that counts each name and the span it opened in."""

    def __init__(self):
        self.count = collections.Counter()
        self.parents = set()
        self._stack = []

    @contextlib.contextmanager
    def __call__(self, name):
        self.count[name] += 1
        self.parents.add((name, self._stack[-1] if self._stack else None))
        self._stack.append(name)
        try:
            yield
        finally:
            self._stack.pop()


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(timer, "recording", lambda: True)
    monkeypatch.setattr(timer, "span", rec)
    return rec


def _want(steps, every, thermo):
    """The one-device spans of run(s) for s in steps, off the fused path:
    none opens once a step."""
    return {"minimd.run": len(steps), "minimd.run.begin": len(steps),
            "minimd.run.end": len(steps),
            "minimd.interval": sum(-(-s // every) for s in steps),
            "minimd.rebin": sum(s // every for s in steps),
            "minimd.thermo": thermo}


LOOP = {("minimd.run", None), ("minimd.run.begin", "minimd.run"),
        ("minimd.run.end", "minimd.run"), ("minimd.interval", "minimd.run"),
        ("minimd.rebin", "minimd.interval"),
        ("minimd.thermo", "minimd.interval")}


@pytest.mark.parametrize("style,fused", [("lj", False), ("eam", False),
                                         ("lj", True)])
def test_run_spans_counts_and_nesting(style, fused, recorder):
    """run(40) then run(10), reneighbor and thermo every 20: 2 + 1
    intervals (the second call's partial), 2 rebins, thermo rows at 20,
    40 and the second call's last step, no span a step; the set-up spans
    once each. Each complete interval of the fused step opens one kick,
    its seed. The tables part opens twice: the potential's read, then
    the fit the chosen force path reads."""
    sim = Simulation.from_input(_deck(style), ntypes=1, device="cpu",
                                fused_step=fused)
    sim.run(40)
    sim.run(10)
    want = _want([40, 10], 20, 3)
    loop = set(LOOP)
    if fused:
        want["minimd.kick"] = 2
        loop.add(("minimd.kick", "minimd.interval"))
    assert recorder.count == {**want,
                              **{f"minimd.setup.{k}": 1 for k in SETUP},
                              "minimd.setup.tables": 2}
    assert recorder.parents == loop | {(f"minimd.setup.{k}", None)
                                       for k in SETUP}


def test_profiler_records_the_same_ranges():
    """Under torch.profiler the real record_function ranges have the
    names, counts and nesting the recorder sees (run(4) + run(1),
    reneighbor and thermo every 2)."""
    sim = Simulation.from_input(_deck("lj", nstat=2, every=2), ntypes=1,
                                device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timer.recording() and timer.spans() is timer.span
        sim.run(4)
        sim.run(1)
    evs = [e for e in prof.events() if e.name.startswith("minimd.")]
    assert collections.Counter(e.name for e in evs) == _want([4, 1], 2, 3)
    assert {(e.name, e.cpu_parent.name if e.cpu_parent else None)
            for e in evs} == LOOP


def test_no_span_and_no_clock_without_a_profiler(monkeypatch):
    """With no profiler recording, run() enters no record_function and
    reads no clock; the rows and the state equal a profiled run's bit for
    bit."""
    inp = _deck("lj")
    prd, x, v, typ, mass = create.setup_system(inp, 1, None)
    args = (inp, prd, x, v, typ, mass)
    traced = Simulation.from_arrays(*args, ntypes=1, device="cpu")
    plain = Simulation.from_arrays(*args, ntypes=1, device="cpu")
    assert not timer.recording() and timer.spans() is timer.no_span
    assert timer.no_span("a") is timer.no_span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        want = traced.run(40)

    calls = []

    def counted(*a):
        calls.append(a)
        return 0.0

    monkeypatch.setattr(timer, "span", lambda name: calls.append(name))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    monkeypatch.setattr(torch._C._autograd,
                        "_record_function_with_args_enter",
                        lambda name: calls.append(name))
    monkeypatch.setattr(timer, "time", types.SimpleNamespace(
        perf_counter=counted, time=counted))
    got = plain.run(40)
    assert calls == []
    assert np.array_equal(got, want)
    assert torch.equal(plain.state.x, traced.state.x)
    assert torch.equal(plain.state.v, traced.state.v)


def test_setup_record_parts_within_from_arrays():
    """The record's parts, in order, sum to no more than from_arrays'
    wall time, and it is the process's last_setup; a regrow leaves the
    record as it was."""
    inp = _deck("eam", s=6)
    prd, x, v, typ, mass = create.setup_system(inp, 1, None)
    t0 = time.perf_counter()
    sim = Simulation.from_arrays(inp, prd, x, v, typ, mass, ntypes=1,
                                 device="cpu")
    wall = time.perf_counter() - t0
    rec = sim.setup_record
    assert list(rec) == [*SETUP, "built"] and rec["built"] is False
    assert all(rec[k] >= 0 for k in SETUP)
    assert sum(rec[k] for k in SETUP) <= wall
    assert timer.last_setup is rec
    before = dict(rec)
    sim._regrow(sim.state, 2 * sim.geom.capacity)
    assert sim.setup_record == before and timer.last_setup is rec


def test_sharded_run_spans(recorder):
    """Two domains on the CPU, run(40): the migration every 20 steps, the
    halo on every step (inside the force), a force and two kicks a step,
    a thermo row at 20 and 40; set-up takes Simulation's names."""
    ss = ShardedSimulation.from_input(_deck("lj"), devices=["cpu"] * 2)
    assert list(ss.setup_record) == [
        "tables", "geometry", "kernels", "upload", "first_force", "built"]
    assert timer.last_setup is ss.setup_record
    recorder.count.clear()
    ss.run(40)
    assert recorder.count == {
        "minimd.migrate": 2, "minimd.halo": 40, "minimd.force": 40,
        "minimd.kick": 80, "minimd.thermo": 2}
    assert ("minimd.halo", "minimd.force") in recorder.parents
