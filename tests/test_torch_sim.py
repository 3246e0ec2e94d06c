"""minimd_torch Simulation on the CPU: golden rows, the reference's
statistical acceptance, the whole LJ and EAM slices against minimd_tpu
f64, grow-and-replay, the jax-free import and the CLI."""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimd_tpu import cells as jcells
from minimd_tpu.config import builtin_deck
from minimd_tpu.validate import compare_traces, parse_golden
from minimd_torch import cli, create
from minimd_torch.sim import Simulation
from minimd_torch.state import geometry_from_reference, state_from_reference

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _deck(s, name="lj"):
    inp = builtin_deck(name)
    inp.nx = inp.ny = inp.nz = s
    return inp


@pytest.fixture(scope="module")
def sim_4k():
    return Simulation.from_input(_deck(10), dtype=torch.float64, device="cpu")


def test_step0_exact(sim_4k, golden_dir):
    """Bounds of tests/test_lj_trace.py:20-27."""
    g = parse_golden(golden_dir / "4k.lj").rows[0]
    step, t, u, p = sim_4k._row0
    assert step == g[0] == 0
    assert abs(t - g[1]) < 5e-7
    assert abs(u - g[2]) < 5e-7
    assert abs(p - g[3]) < 5e-6
    assert sim_4k.state.overflow == 0


def test_lj_4k_trace_statistical(sim_4k, golden_dir):
    golden = parse_golden(golden_dir / "4k.lj")
    trace = sim_4k.run(100)
    assert trace.shape == (100, 3) and np.all(np.isfinite(trace))
    rows = sim_4k.thermo_trace(trace)
    assert [r[0] for r in rows] == [0, 100]
    res = compare_traces(rows, golden.rows, natoms=4000, system="lj",
                         precision=8)
    assert res.passed, str(res)
    g100 = {r[0]: r for r in golden.rows}[100]
    assert abs(rows[1][2] - g100[2]) < 2e-4, (rows[1], g100)
    assert sim_4k.state.overflow == 0
    assert int(sim_4k.state.valid.sum()) == 4000


def test_slice_matches_jax_f64():
    """s=6, 20 steps (one reneighbor, the pull rebin on a 3x3x3 grid):
    positions, velocities and thermo rows within 1e-10 of minimd_tpu."""
    from minimd_tpu.sim import Simulation as JaxSimulation

    js = JaxSimulation.from_input(_deck(6), dtype=jnp.float64)
    ts = Simulation.from_input(_deck(6), dtype=torch.float64, device="cpu")
    assert ts.geom.nb == js.geom.nb == (3, 3, 3)
    assert ts.geom.capacity == js.geom.capacity
    jt, tt = js.run(20), ts.run(20)
    for name in ("x", "v"):
        a = np.asarray(getattr(js.state, name))
        b = getattr(ts.state, name).numpy()
        valid = np.asarray(js.state.valid)
        np.testing.assert_array_equal(valid, ts.state.valid.numpy())
        assert np.abs(a[:, valid] - b[:, valid]).max() < 1e-10, name
    assert np.abs(jt - tt).max() < 1e-10
    jr, tr = js.thermo_trace(jt), ts.thermo_trace(tt)
    assert [r[0] for r in tr] == [r[0] for r in jr] == [0, 20]
    assert np.abs(np.array(jr) - np.array(tr)).max() < 1e-10


def test_grow_and_replay_keeps_every_atom():
    """capacity pinned at the t=0 maximum occupancy overflows within 60
    steps (in the third rebin); the run regrows, replays from the pre-run
    state and ends with every atom and the physics of an unpinned run."""
    ref = Simulation.from_input(_deck(6), dtype=torch.float64, device="cpu")
    cap0 = ref.geom.capacity
    occ = ref.state.valid.reshape(ref.geom.ncells, cap0).sum(dim=1)
    tight = int(occ.max())
    sim = Simulation.from_input(_deck(6), dtype=torch.float64, device="cpu",
                                capacity=tight)
    trace = sim.run(60)
    assert sim._regrows >= 1 and sim.geom.capacity > tight
    assert sim.geom.nb == ref.geom.nb          # pinned capacity keeps the grid
    assert sim.state.overflow == 0
    assert int(sim.state.valid.sum()) == sim.natoms == 864
    rtrace = ref.run(60)
    assert np.abs(trace - rtrace).max() < 1e-9
    # another capacity sums the step-0 forces in another order
    np.testing.assert_allclose(sim._row0, ref._row0, rtol=1e-12)


def test_eam_step0_golden(golden_dir):
    """The 4k EAM f64 step-0 row, bounds of tests/test_eam.py:52-58."""
    sim = Simulation.from_input(_deck(10, "eam"), dtype=torch.float64,
                                device="cpu")
    g = parse_golden(golden_dir / "4k.eam").rows[0]
    step, t, u, p = sim._row0
    assert step == g[0] == 0 and sim.natoms == 4000
    assert abs(t - g[1]) < 1e-4
    assert abs(u - g[2]) / abs(g[2]) < 1e-6
    assert abs(p - g[3]) / abs(g[3]) < 1e-5
    assert sim.mass == 63.55 and sim.state.overflow == 0


def test_eam_slice_matches_jax_f64():
    """s=6 EAM, 40 f64 steps (two reneighbors, the pull rebin on a 3x3x3
    grid) from the JAX package's own state carried across: thermo rows,
    positions and velocities within 1e-9 of minimd_tpu."""
    from minimd_tpu.sim import Simulation as JaxSimulation

    js = JaxSimulation.from_input(_deck(6, "eam"), dtype=jnp.float64)
    ts = Simulation.from_state(
        _deck(6, "eam"), geometry_from_reference(js.geom),
        state_from_reference(js.state, dtype=torch.float64), js.mass,
        dtype=torch.float64, device="cpu")
    assert ts.geom.nb == (3, 3, 3) and ts.natoms == js.natoms == 864
    assert ts.mass == js.mass
    np.testing.assert_allclose(ts._row0, js._row0, rtol=1e-12)
    jt, tt = js.run(40), ts.run(40)
    assert ts.state.overflow == 0
    valid = np.asarray(js.state.valid)
    np.testing.assert_array_equal(valid, ts.state.valid.numpy())
    for name in ("x", "v"):
        a = np.asarray(getattr(js.state, name))[:, valid]
        b = getattr(ts.state, name).numpy()[:, valid]
        assert np.abs(a - b).max() < 1e-9, name
    jr, tr = js.thermo_trace(jt), ts.thermo_trace(tt)
    assert [r[0] for r in tr] == [r[0] for r in jr] == [0, 40]
    np.testing.assert_allclose(np.array(tr), np.array(jr), rtol=1e-9)


SUBPROCESS_JAX_BLOCKED = r"""
import sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["minimd_tpu"] = None   # and so does any of the JAX package
import torch
torch.set_num_threads(2)
import minimd_torch
from minimd_torch.sim import Simulation
for deck in ("lj", "eam"):
    inp = minimd_torch.builtin_deck(deck)
    inp.nx = inp.ny = inp.nz = 6
    sim = Simulation.from_input(inp, dtype=torch.float32, device="cpu")
    trace = sim.run(20)
    assert trace.shape == (20, 3) and sim.state.overflow == 0
    print("ROW", deck, *sim.thermo_trace(trace)[-1])
assert not any(m == "jax" or m.startswith(("jax.", "minimd_tpu"))
               for m in sys.modules if sys.modules[m] is not None)
"""


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_is_jax_free():
    res = _run(["-c", SUBPROCESS_JAX_BLOCKED])
    assert res.returncode == 0, res.stderr
    rows = [ln.split()[1:] for ln in res.stdout.splitlines()
            if ln.startswith("ROW")]
    assert [r[0] for r in rows] == ["lj", "eam"]
    for row in rows:
        assert row[1] == "20" and all(np.isfinite(float(v)) for v in row[2:])


def test_cli_module_runs(golden_dir):
    res = _run(["-m", "minimd_torch", "-s", "6", "-n", "20",
                "--device", "cpu"])
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    i = lines.index("# Timestep T U P Time")
    step0 = lines[i + 1].split()
    assert step0[:2] == ["0", "1.440000e+00"]
    assert lines[i + 2].split()[0] == "20"
    perf = [ln for ln in lines if "PERF_SUMMARY" in ln]
    assert len(perf) == 1 and perf[0].split()[2:4] == ["20", "864"]


def test_cli_runs_eam_deck(capsys):
    cli.main(["-i", str(REPO / "inputs/in.eam.miniMD"), "-s", "6", "-n",
              "20", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert "\t# ForceStyle: EAM" in lines and "\t# Units: METAL" in lines
    i = lines.index("# Timestep T U P Time")
    assert lines[i + 1].startswith("0 6.000000e+02")
    assert lines[i + 2].split()[0] == "20"


@pytest.mark.parametrize("argv", [["--devices", "2"], ["--half_neigh", "1"],
                                  ["--timed"], ["-o", "1"],
                                  ["--profile", "trace"]])
def test_cli_refuses_unported_flags(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["-s", "6", "--device", "cpu", *argv])
    assert "not ported" in str(exc.value.code)
    assert "ROADMAP" in str(exc.value.code)


def test_from_input_builds_eam_deck():
    """The EAM deck on the CPU: Cu mass and metal units from the deck and
    the potential file, the JAX package's solid-vouched geometry."""
    inp = _deck(6, "eam")
    sim = Simulation.from_input(inp, device="cpu")
    assert sim.tables is not None and sim.params is None
    assert sim.natoms == 864 and sim.mass == 63.55
    prd, x, _, _, _ = create.setup_system(inp)
    want = jcells.build_geometry(prd, inp.neigh_cut, x, solid=True)
    assert (sim.geom.nb, sim.geom.capacity) == (want.nb, want.capacity)
    liquid = jcells.build_geometry(prd, inp.neigh_cut, x)
    assert liquid.capacity > want.capacity == 40
    assert abs(sim._row0[1] - 600.0) < 1e-3


@pytest.mark.parametrize("what", ["half_neigh", "fused_step"])
def test_from_input_refuses_unported(what):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation.from_input(_deck(6), device="cpu", **{what: True})
