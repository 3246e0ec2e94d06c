"""minimd_torch's CLI, timed run, YAML report and checkpoint on the CPU,
mirroring the JAX package's tests/test_cli.py and tests/test_checkpoint.py
at -s 6 and 20 steps or fewer, plus checkpoints that cross between the two
packages."""

import contextlib
import io
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from minimd_torch import checkpoint, cli, output
from minimd_torch.config import builtin_deck
from minimd_torch.sim import Simulation
from minimd_torch.timer import TIME_FORCE, TIME_NEIGH, Timer

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
ROW = re.compile(r"^\d+ -?\d\.\d+e[+-]\d+ ")


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([*argv, "--device", "cpu"])
    return buf.getvalue()


def _rows(out):
    """[T, U, P] of the printed thermo rows (the 5th field is wall time)."""
    return [[float(v) for v in ln.split()[:4]] for ln in out.splitlines()
            if ROW.match(ln)]


def _perf(out):
    return next(ln for ln in out.splitlines()
                if "PERF_SUMMARY" in ln and not ln.startswith("#")).split()


def _deck(s=6, name="lj", nstat=None):
    inp = builtin_deck(name)
    inp.nx = inp.ny = inp.nz = s
    if nstat is not None:
        inp.thermo_nstat = nstat
    return inp


def test_parser_accepts_reference_command_lines():
    """The reference harness's invocation shape (run_one_test:50)."""
    a = cli.build_parser().parse_args(
        ["-t", "4", "-s", "16", "-n", "100", "--half_neigh", "0", "-gn",
         "0", "--yaml_output", "0", "-dm", "-i", "in.lj.miniMD", "--sort",
         "1", "--teams", "2", "-ng", "1", "--skip_gpu", "0"])
    assert a.size == 16 and a.nsteps == 100 and a.ghost_newton == 0


def test_cli_end_to_end_tiny():
    out = _run(["-s", "6", "-n", "10", "--ntypes", "2"])
    assert "# Timestep T U P Time" in out and "PERF_SUMMARY" in out
    # the golden LJ step-0 row at any size (BASELINE.md)
    assert "0 1.440000e+00" in out
    assert _perf(out)[2:4] == ["10", "864"]


def test_cli_half_neigh_runs():
    """--half_neigh 1: the step-0 golden row is unchanged."""
    out = _run(["-s", "6", "-n", "10", "--half_neigh", "1"])
    assert "0 1.440000e+00" in out and "PERF_SUMMARY" in out
    assert "\t# Half neighborlists: 1" in out


def test_cli_timed_check_exchange_yaml(tmp_path, monkeypatch):
    """--timed fills t_force and t_neigh, --check_exchange runs its audit,
    -o 1 writes the report with lost_atoms: 0."""
    monkeypatch.chdir(tmp_path)
    out = _run(["-s", "6", "-n", "20", "--timed", "--check_exchange",
                "--yaml_output", "1", "--yaml_screen"])
    f = _perf(out)
    assert float(f[5]) > 0 and float(f[6]) > 0     # t_force, t_neigh
    assert "conservation_ratio" in out and "lost_atoms: 0" in out
    assert "neighbors_within_cutoff" in out
    yamls = list(tmp_path.glob("miniMD-*.yaml"))
    assert len(yamls) == 1 and "lost_atoms: 0" in yamls[0].read_text()


def test_cli_profile_writes_trace(tmp_path):
    d = tmp_path / "trace"
    out = _run(["-s", "6", "-n", "5", "--profile", str(d)])
    assert "# profiler trace:" in out
    assert (d / "minimd_torch_trace.json").stat().st_size > 0


def test_cli_sse_exits():
    with pytest.raises(SystemExit):
        cli.main(["-sse", "1"])


def test_cli_nstat0_start_end_rows(tmp_path):
    """thermo_nstat = 0 prints the start and end rows only
    (ref thermo.cpp:49-50,95-99); the end row has real energy."""
    lines = (REPO / "inputs" / "in.lj.miniMD").read_text().splitlines()
    lines[-1] = "0              thermo calculation every this many steps"
    deck = tmp_path / "in.nstat0"
    deck.write_text("\n".join(lines) + "\n")
    out = _run(["-i", str(deck), "-s", "6", "-n", "15"])
    rows = _rows(out)
    assert [int(r[0]) for r in rows] == [0, 15]
    assert abs(rows[1][2]) > 1.0


def test_cli_eam_half_neigh_runs():
    out = _run(["-i", str(REPO / "inputs/in.eam.miniMD"), "-s", "4", "-n",
                "10", "--half_neigh", "1", "--precision", "2", "-gn", "0"])
    assert "PERF_SUMMARY" in out and "0 6.000000e+02" in out
    assert "fold regardless of -gn" in out


def test_cli_ghost_newton_variants():
    """-gn 0 and -gn 1 print the same f64 rows to 1e-9 relative, compared
    as numbers (their summation orders differ); the banner and the note
    name the variant."""
    out0 = _run(["-s", "6", "-n", "10", "--half_neigh", "1", "-gn", "0",
                 "--precision", "2"])
    out1 = _run(["-s", "6", "-n", "10", "--half_neigh", "1", "-gn", "1",
                 "--precision", "2"])
    assert "duplicates boundary pairs" in out0
    assert "duplicates boundary pairs" not in out1
    assert "# Ghost Newton: 0" in out0 and "# Ghost Newton: 1" in out1
    r0, r1 = np.array(_rows(out0)), np.array(_rows(out1))
    assert r0.shape == r1.shape == (2, 4)
    np.testing.assert_allclose(r0, r1, rtol=1e-9)


@pytest.mark.parametrize("half", [False, True], ids=["full", "half"])
def test_run_timed_rows_equal_run(half):
    """run_timed runs run()'s steps in run()'s order: with no rebin
    overflow, the same trace bit for bit, and the phase buckets filled."""
    a = Simulation.from_input(_deck(nstat=5), device="cpu", half_neigh=half)
    b = Simulation.from_input(_deck(nstat=5), device="cpu", half_neigh=half)
    timer = Timer()
    ta, tb = a.run(20), b.run_timed(timer, 20, check_exchange=True)
    np.testing.assert_array_equal(ta, tb)
    assert a.thermo_trace(ta) == b.thermo_trace(tb)
    assert torch.equal(a.state.x, b.state.x)
    assert timer.array[TIME_FORCE] > 0 and timer.array[TIME_NEIGH] > 0


def test_run_timed_overflow_grows_and_continues(capsys):
    """A capacity pinned at the t=0 maximum overflows in a rebin; the
    timed run grows it, goes on from the re-laid-out state and keeps
    every atom; its rows then track run()'s (which replays from the start
    on the grown grid) to summation order, not bit for bit."""
    ref = Simulation.from_input(_deck(), dtype=torch.float64, device="cpu")
    occ = ref.state.valid.reshape(ref.geom.ncells, -1).sum(dim=1)
    sim = Simulation.from_input(_deck(), dtype=torch.float64, device="cpu",
                                capacity=int(occ.max()))
    trace = sim.run_timed(Timer(), 60)
    assert "re-laying out" in capsys.readouterr().out
    assert sim._regrows >= 1 and sim.state.overflow == 0
    assert int(sim.state.valid.sum()) == sim.natoms == 864
    assert output.lost_atom_check(sim) == 0
    np.testing.assert_allclose(trace[-1], ref.run(60)[-1], rtol=1e-9)


def test_lost_atom_check_looks_at_positions():
    """The audit counts atoms inside the box (output.cpp:60-85): a valid
    slot whose atom left by more than one box length, or is not finite,
    is lost; a drift past a face within one image is not."""
    sim = Simulation.from_input(_deck(), dtype=torch.float64, device="cpu")
    assert output.lost_atom_check(sim) == 0
    slots = torch.nonzero(sim.state.valid).flatten()[:3]
    prd = sim.geom.prd[0]
    sim.state.x[0, slots[0]] = -0.1               # drifted, still counted
    sim.state.x[0, slots[1]] = 2.5 * prd          # gone
    sim.state.x[1, slots[2]] = float("nan")       # gone
    assert output.lost_atom_check(sim) == 2


def test_run_statistics_names_what_it_skips(monkeypatch):
    sim = Simulation.from_input(_deck(), device="cpu")
    stats = output.run_statistics(sim)
    assert stats["neighbors_within_cutoff"]["max"] > 0
    assert "skipped" not in stats
    monkeypatch.setitem(__import__("sys").modules, "scipy.spatial", None)
    stats = output.run_statistics(sim)
    assert "neighbors_within_cutoff" not in stats
    assert "scipy" in stats["skipped"]["neighbors_within_cutoff"]


@pytest.fixture
def saved(tmp_path):
    """A f64 s=6 run saved at step 10, and the original run continued 10
    steps."""
    sim = Simulation.from_input(_deck(), dtype=torch.float64, device="cpu")
    row0 = sim._row0
    sim.run(10)
    path = tmp_path / "ck.npz"
    checkpoint.save(path, sim, step=10)
    return path, sim, row0, sim.run(10)


def test_checkpoint_resume_continues_trajectory(saved):
    path, sim, _, tr_orig = saved
    sim2, step = checkpoint.resume(path, dtype=torch.float64, device="cpu")
    assert step == 10 and sim2.natoms == sim.natoms
    tr_res = sim2.run(10)
    np.testing.assert_allclose(tr_res[:, 0], tr_orig[:, 0], rtol=1e-8,
                               atol=1e-9)


def test_checkpoint_resume_thermo_provenance(saved):
    """The resumed run's step-0 row is the original run's."""
    path, _, row0, _ = saved
    sim2, _ = checkpoint.resume(path, dtype=torch.float64, device="cpu")
    assert sim2._row0 == row0
    assert abs(sim2.thermo_row(10)[1] - row0[1]) > 1e-3


def test_checkpoint_resume_takes_sim_options(saved):
    path, _, _, tr_orig = saved
    sim2, _ = checkpoint.resume(path, dtype=torch.float64, device="cpu",
                                half_neigh=True, capacity=56)
    assert sim2.half_neigh and sim2.geom.capacity == 56
    np.testing.assert_allclose(sim2.run(10)[:, 0], tr_orig[:, 0], rtol=1e-8,
                               atol=1e-9)


def test_port_checkpoint_loads_in_jax_package(saved):
    from minimd_tpu import checkpoint as jcheckpoint
    from minimd_tpu.config import In as JIn

    path, sim, row0, _ = saved
    inp, prd, x, v, typ, mass, step, jrow0 = jcheckpoint.load(path)
    assert isinstance(inp, JIn) and inp.nx == 6 and step == 10
    assert jrow0 == row0 and mass == sim.mass and len(x) == 864
    np.testing.assert_array_equal(prd, np.asarray(sim.geom.prd))
    assert x.min() >= 0 and (x < prd).all()


def test_jax_checkpoint_resumes_in_port(saved, tmp_path):
    """A file written by minimd_tpu.checkpoint.save (from plain numpy
    arrays, no JAX compile) resumes in the port and continues the
    trajectory."""
    from minimd_tpu import checkpoint as jcheckpoint
    from minimd_tpu.config import builtin_deck as jax_deck

    _, sim, row0, tr_orig = saved
    jinp = jax_deck("lj")
    jinp.nx = jinp.ny = jinp.nz = 6
    saved_sim = types.SimpleNamespace(
        state=types.SimpleNamespace(
            x=sim.state.x.numpy(), v=sim.state.v.numpy(),
            typ=sim.state.typ.numpy(), valid=sim.state.valid.numpy()),
        geom=types.SimpleNamespace(prd=np.asarray(sim.geom.prd)),
        mass=sim.mass, inp=jinp, _row0=row0)
    # sim has run 20 steps; its state is the original's at step 20
    path = tmp_path / "jax.npz"
    jcheckpoint.save(path, saved_sim, step=20)
    res, step = checkpoint.resume(path, dtype=torch.float64, device="cpu")
    assert step == 20 and res._row0 == row0 and res.natoms == 864
    cont = sim.run(10)
    np.testing.assert_allclose(res.run(10)[:, 0], cont[:, 0], rtol=1e-8,
                               atol=1e-9)
