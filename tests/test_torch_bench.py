"""minimd_torch.bench and minimd_torch.perf on the CPU at small sizes: the
slope timing gives a finite rate above 0 with every atom kept, a lost
atom or a regrown layout raises, and without a card both entry points
exit non-zero before any set-up.

The slopes span 2 against 12 steps: at 864 atoms on an 8-core CPU an LJ
run(2) took 35-98 ms and a run(6) 102-130 ms, too close for a slope that
must come out positive while other tests load the cores."""

import math

import pytest
import torch

from minimd_torch import bench, perf
from minimd_torch.parallel import ShardedSimulation
from minimd_torch.sim import Simulation


@pytest.mark.parametrize("style", ["lj", "eam"])
def test_throughput_keeps_every_atom(style, capsys):
    rate = bench.throughput(style, 6, 2, 12, reps=1, device="cpu")
    assert math.isfinite(rate) and rate > 0
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith(f"[slope] {style} -s 6 (864 atoms) 1/1: run(2)")


@pytest.mark.parametrize("ndev", [1, 8])
def test_throughput_sharded_keeps_every_atom(ndev, capsys):
    """1 domain, and 8 on a (2,2,2) mesh, which the 6^3 lattice admits."""
    rate = bench.throughput_sharded("lj", 6, 2, 12, ndev=ndev, reps=1,
                                    device="cpu")
    assert math.isfinite(rate) and rate > 0
    k = 2 if ndev == 8 else 1
    mesh = f"{{'z': {k}, 'y': {k}, 'x': {k}}}"
    assert f"sharded {ndev} domain(s) mesh {mesh}" in capsys.readouterr().out


def test_check_kept_refuses_a_lost_atom_and_a_regrow():
    sim = Simulation.from_input(bench.sized_deck("lj", 4), device="cpu")
    layout = (sim.geom.nb, sim.geom.capacity)
    bench.check_kept(sim, layout, "lj")
    with pytest.raises(RuntimeError, match="layout"):
        bench.check_kept(sim, (sim.geom.nb, sim.geom.capacity - 1), "lj")
    sim.state.valid[int(torch.nonzero(sim.state.valid)[0])] = False
    with pytest.raises(RuntimeError, match="255 of 256 atoms kept"):
        bench.check_kept(sim, layout, "lj")


def test_perf_prints_its_two_lines(capsys):
    got = perf.measure("lj", 6, (2, 12), device="cpu")
    first, second = capsys.readouterr().out.splitlines()
    assert first.startswith("natoms=864 grid=(") and " C=" in first
    assert first.endswith("device=cpu")
    assert second.startswith("per_step=") and "throughput=" in second
    assert second.endswith("overflow=0")
    assert got["natoms"] == 864 and got["rate"] > 0


@pytest.mark.parametrize("entry, argv", [
    (bench.main, []), (bench.main, ["--devices", "8"]), (perf.main, [])])
def test_no_card_exits_before_set_up(monkeypatch, entry, argv):
    def set_up(*args, **kwargs):
        raise AssertionError("set-up ran without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (Simulation, ShardedSimulation):
        monkeypatch.setattr(cls, "from_input", set_up)
    monkeypatch.setattr(bench, "sized_deck", set_up)
    monkeypatch.setattr(bench, "card_line", set_up)
    with pytest.raises(SystemExit) as exc:
        entry(argv)
    assert exc.value.code not in (0, None)
