"""`python -m minimd_torch.run_tests` on the CPU (--device cpu, f64): a
golden case passes, the data cases give the deck's rows bit for bit, two
domains give one device's rows, and main builds the JAX script's case
lists, statuses and exit codes."""

import numpy as np
import pytest
import torch

from minimd_torch import run_tests
from minimd_torch.config import builtin_deck
from minimd_torch.sim import Simulation


def test_lj_4k_passes_golden():
    """LJ -s 10, 100 steps, f64 on the CPU: the comparator against
    tests/golden/4k.lj passes, step 0 to the golden's printed digits."""
    res, rows, skip = run_tests.run_case("lj", 10, 100, 8, device="cpu")
    assert skip is None and res.passed and res.nsteps == 2
    assert [r[0] for r in rows] == [0, 100]
    assert np.allclose(rows[0][1:], (1.44, -6.773368, -5.019973),
                       rtol=1e-6, atol=0)


@pytest.fixture
def one_thread():
    """One intra-op thread for the bit-for-bit comparisons below. With 8,
    the first EAM Simulation built after the LJ tests of this file once
    took a step-0 energy ~3 ulp off in about half of the runs: the plain
    paths' scalar sums then split among the threads that joined them.
    thermo.ordered_sum now fixes their order (tests/test_torch_threads.py);
    the fixture stays as a second guard."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lj_data_rows_equal_deck_rows(one_thread):
    """The lj-data case (the deck's lattice written with the port's writer
    and read through -f) runs the lj case's rows bit for bit (-s 6, 40
    steps, thermo every 10)."""
    sims = [run_tests.case_simulation(name, 6, torch.float64, "cpu",
                                      thermo_nstat=10)
            for name in ("lj", "lj-data")]
    deck, data = (s.thermo_trace(s.run(40)) for s in sims)
    assert len(deck) == 5 and deck == data
    assert sims[1].inp.datafile is not None


def test_eam_data_rows_equal_deck_rows(one_thread):
    """eam-data against eam at -s 6, 20 steps, thermo every 10, bit for
    bit. The data path picks its cell capacity without the solid-lattice
    vouch (as the JAX package does), so the deck run takes the data
    run's capacity: the thermo sums then run over the same slots."""
    data = run_tests.case_simulation("eam-data", 6, torch.float64, "cpu",
                                     thermo_nstat=10)
    inp = builtin_deck("eam")
    inp.nx = inp.ny = inp.nz = 6
    inp.thermo_nstat = 10
    deck = Simulation.from_input(inp, dtype=torch.float64, device="cpu",
                                 capacity=data.geom.capacity)
    assert deck.geom.nb == data.geom.nb and deck.mass == data.mass
    assert deck.thermo_trace(deck.run(20)) == data.thermo_trace(data.run(20))


def test_two_domains_match_one_device():
    """--devices 2 on CPU domains: a ShardedSimulation whose rows are the
    one-device rows to 1e-10 (LJ -s 6, 40 steps)."""
    one, two = (run_tests.case_simulation("lj", 6, torch.float64, "cpu",
                                          devices=n, thermo_nstat=10)
                for n in (1, 2))
    assert two.mesh.size == 2
    a, b = (s.thermo_trace(s.run(40)) for s in (one, two))
    assert [r[0] for r in a] == [r[0] for r in b]
    for ra, rb in zip(a, b):
        assert np.allclose(ra[1:], rb[1:], rtol=1e-10, atol=0)


class _Res:
    def __init__(self, passed):
        self.passed = passed

    def __str__(self):
        return "PASSED" if self.passed else "FAILED"


@pytest.mark.parametrize("argv, cases, fail, rc", [
    (["--scope", "quick", "--device", "cpu"],
     [("lj", 10, 500), ("eam", 10, 500)], set(), 0),
    (["--scope", "full", "--device", "cpu"],
     [("lj", 10, 10000), ("lj", 16, 500), ("lj", 20, 500), ("eam", 10, 500),
      ("eam", 16, 200), ("lj-data", 16, 500), ("eam-data", 16, 200)],
     {("lj", 16)}, 1),
    (["--scope", "large", "--device", "cpu"],
     [("lj", 40, 200), ("lj", 60, 200), ("eam", 40, 200), ("eam", 60, 200)],
     {("eam", 40)}, 1),
    (["--scope", "quick"], [("lj", 10, 10000), ("eam", 10, 10000)],
     set(), 0),
    (["--scope", "full"],
     [("lj", 10, 10000), ("lj", 20, 2000), ("eam", 10, 10000)], set(), 0),
    (["--scope", "large"],
     [("lj", 40, 2000), ("lj", 60, 1000), ("eam", 20, 10000),
      ("eam", 40, 1000)], {("eam", 40)}, 0),
    (["--scope", "large"],
     [("lj", 40, 2000), ("lj", 60, 1000), ("eam", 20, 10000),
      ("eam", 40, 1000)], {("lj", 60)}, 1),
    (["--input", "eam-data", "--size", "12", "--steps", "30", "--device",
      "cpu", "--devices", "2", "--half_neigh", "1", "--ghost_newton", "0"],
     [("eam-data", 12, 30)], set(), 0),
], ids=["quick-cpu", "full-cpu-fail", "large-cpu-fail", "quick-cuda",
        "full-cuda", "large-cuda-xfail", "large-cuda-fail", "single-skip"])
def test_main_cases_statuses_exit_codes(monkeypatch, capsys, argv, cases,
                                        fail, rc):
    """main with run_case stubbed: the scope's (input, size, steps) in
    order, precision 8 on the CPU and 4 on the card, the options passed
    through, PASS / FAIL / XFAIL (f32 EAM 256k+) / SKIP (no golden log)
    lines, and exit code 1 exactly when a case FAILs."""
    calls = []

    def stub(name, size, steps, precision, device="cuda", devices=1,
             half_neigh=False, ghost_newton=True):
        calls.append((name, size, steps, precision, device, devices,
                      half_neigh, ghost_newton))
        if size == 12:
            return None, None, "no golden log 12.eam"
        return _Res((name, size) not in fail), [], None

    monkeypatch.setattr(run_tests, "run_case", stub)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert run_tests.main(argv) == rc
    cuda = "cpu" not in argv
    assert [c[:3] for c in calls] == cases
    assert {c[3:5] for c in calls} == {(4, "cuda") if cuda else (8, "cpu")}
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(cases)
    for (name, size, steps), line in zip(cases, out):
        status = ("SKIP" if size == 12 else "PASS"
                  if (name, size) not in fail else "XFAIL"
                  if cuda and (name, size) in run_tests.XFAIL_F32 else "FAIL")
        assert line.split()[0] == status
        assert f"{name} -s {size} -n {steps} (precision " in line
    if "--devices" in argv:
        assert calls[0][5:] == (2, True, False)
        assert out[0].endswith("(precision 8, devices 2, half_neigh, gn=0): "
                               "no golden log 12.eam")


def test_main_without_a_card_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        run_tests.main(["--scope", "quick"])
