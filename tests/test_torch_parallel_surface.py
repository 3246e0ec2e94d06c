"""The surface of minimd_torch's decomposed run on the CPU: run_timed
(rows equal run()'s bit for bit, the thermo cadence on global step
numbers, interval_stamps, a capacity regrow inside it),
per_device_statistics against the JAX package's on the same state, the
checkpoint of a ShardedSimulation (its step-0 row kept) and
resume_sharded, the CLI's --devices N, and dryrun_multichip. Meshes are
lists of CPU domains, in float64 unless the CLI's default (float32)
runs."""

import types

import numpy as np
import pytest
import torch

from minimd_tpu.output import per_device_statistics as jax_device_stats
from minimd_torch import checkpoint, cli, create
from minimd_torch.config import builtin_deck
from minimd_torch.output import (lost_atom_check, per_device_statistics,
                                 run_statistics)
from minimd_torch.parallel import ShardedSimulation, mesh_devices
from minimd_torch.parallel.dryrun import dryrun_multichip
from minimd_torch.state import sharded_to_grid
from minimd_torch.timer import TIME_COMM, TIME_FORCE, TIME_NEIGH, Timer

torch.set_num_threads(2)
F64 = torch.float64


def _deck(s=8, every=20, nstat=50):
    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = s
    inp.neigh_every = every
    inp.thermo_nstat = nstat
    return inp


def _sim(inp=None, ndom=8, **kw):
    return ShardedSimulation.from_input(
        inp or _deck(), devices=["cpu"] * ndom, dtype=F64,
        nbins=(4, 4, 4), **kw)


@pytest.fixture(scope="module")
def timed():
    """The cadence case (minimd_tpu's test_multichip.py:797-823): LJ at
    2,048 atoms on (2,2,2), reneighbor every 20 steps and thermo every 50,
    100 steps through run() and through run_timed()."""
    plain, timed_sim = _sim(), _sim()
    timer = Timer()
    return (plain, plain.run(100), timed_sim,
            timed_sim.run_timed(timer, 100), timer)


def test_run_timed_rows_equal_run(timed):
    """The same steps in the same order: the trace and the final state
    bit for bit run()'s; step 50 lands inside an interval and its row is
    a real one; one stamp triple per interval, which sum to the timer's
    phases."""
    plain, want, sim, got, timer = timed
    np.testing.assert_array_equal(got, want)
    rows = sim.thermo_trace(got)
    assert [r[0] for r in rows] == [0, 50, 100]
    assert all(abs(r[2]) > 1.0 for r in rows)     # U ~ -6.7, never 0
    for k in ("x", "v", "f", "typ", "valid"):
        assert torch.equal(getattr(sim.state, k), getattr(plain.state, k))
    assert len(sim.interval_stamps) == 5
    st = np.asarray(sim.interval_stamps)
    assert (st > 0).all()
    np.testing.assert_allclose(
        st.sum(axis=0), [timer.array[k] for k in
                         (TIME_FORCE, TIME_COMM, TIME_NEIGH)], rtol=1e-12)


def test_half_run_timed_rows_equal_run():
    """The half-neighbor path (-gn 0, 4 domains) timed: the same rows bit
    for bit, its halo stamped as COMM."""
    sims = [_sim(_deck(6, every=5, nstat=5), ndom=4, half_neigh=True,
                 ghost_newton=False) for _ in range(2)]
    timer = Timer()
    want = sims[0].run(10)
    got = sims[1].run_timed(timer, 10)
    np.testing.assert_array_equal(got, want)
    assert len(sims[1].interval_stamps) == 2 and timer.array[TIME_COMM] > 0


def test_run_timed_survives_regrow():
    """A capacity pinned at the starting maximum occupancy overflows at the
    first migration inside run_timed (check_exchange on): the interval is
    grown and replayed, every atom kept, and the run ends as one with
    room from the start (minimd_tpu's test_multichip.py:928-960)."""
    inp = _deck(6, every=20, nstat=20)
    prd, x, v, typ, mass = create.setup_system(inp, 1, None)

    def make(**kw):
        return ShardedSimulation.from_arrays(
            inp, prd, x, 3.0 * v, typ, mass, devices=["cpu"] * 2,
            dtype=F64, nbins=(3, 3, 4), **kw)

    ref = make()
    tight = int(ref.state.valid.reshape(-1, ref.geom.capacity)
                .sum(dim=1).max())
    want = ref.run(60)
    sim = make(capacity=tight)
    got = sim.run_timed(Timer(), 60, check_exchange=True)
    assert sim.geom.capacity > tight
    assert int(sim.state.valid.sum()) == sim.natoms == 864
    assert np.isfinite(got).all() and len(sim.interval_stamps) == 3
    for r, q in zip(sim.thermo_trace(got), ref.thermo_trace(want)):
        assert r[0] == q[0]
        np.testing.assert_allclose(r[1:], q[1:], rtol=1e-9, atol=0)


def test_per_device_statistics_match_jax(timed):
    """The JAX package's keys, and its values when its function reads the
    same state (the port's domains gathered into its grid arrays) and
    the same interval stamps; the audit and the run statistics take a
    ShardedSimulation."""
    _, _, sim, _, _ = timed
    got = per_device_statistics(sim)
    arrays = sharded_to_grid(sim.state_, sim.mesh, sim.geom)
    want = jax_device_stats(types.SimpleNamespace(
        arrays=arrays, mesh=sim.mesh, geom=sim.geom,
        interval_stamps=sim.interval_stamps))
    assert set(got) == set(want)
    notes = {"time_per_device_note", "time_attribution_note"}
    assert {k: got[k] for k in got if k not in notes} == \
        {k: want[k] for k in want if k not in notes}
    assert sum(got["atoms_per_device_list"]) == sim.natoms == 2048
    assert got["swap_atoms_x_per_device"]["min"] > 0
    assert "SPMD" not in got["time_per_device_note"]
    assert lost_atom_check(sim) == 0
    assert run_statistics(sim)["cell_occupancy"]["ave"] == 2048 / 64


def test_checkpoint_keeps_row0_and_resumes(tmp_path):
    """A saved ShardedSimulation keeps its step-0 row (it lived in `row0`,
    which save did not read); resume_sharded continues the uninterrupted
    run with the saved force options (here the half path, -gn 0), the
    original step-0 row kept."""
    sim = _sim(_deck(6, every=10, nstat=10), ndom=4, half_neigh=True,
               ghost_newton=False)
    sim.run(20)
    path = tmp_path / "ck.npz"
    checkpoint.save(path, sim, step=20)
    assert checkpoint.load(path)[-1] == sim.row0 != (0, 0.0, 0.0, 0.0)
    orig = sim.thermo_trace(sim.run(20))
    res, step = checkpoint.resume_sharded(path, devices=["cpu"] * 4,
                                          dtype=F64, nbins=(4, 4, 4))
    assert step == 20 and res.mesh.shape == sim.mesh.shape
    assert res.half_neigh and not res.ghost_newton
    rows = res.thermo_trace(res.run(20))
    assert rows[0] == orig[0] == sim.row0
    for r, q in zip(rows[1:], orig[1:]):
        assert r[0] == q[0]
        np.testing.assert_allclose(r[1:], q[1:], rtol=1e-9, atol=0)
    assert int(res.state.valid.sum()) == res.natoms


@pytest.mark.parametrize("extra", [[], ["--half_neigh", "1", "--timed",
                                        "-o", "1"]],
                         ids=["plain", "half-timed-yaml"])
def test_cli_devices(extra, tmp_path, capsys, monkeypatch):
    """python -m minimd_torch --devices 8 --device cpu: the mesh and the
    domains' devices, the rows that ShardedSimulation gives, a
    PERF_SUMMARY line with the devices column, and with -o 1 a YAML
    report with the per-device statistics and lost_atoms: 0."""
    monkeypatch.chdir(tmp_path)
    argv = ["-s", "8", "-n", "20", "-b", "4", "--devices", "8",
            "--device", "cpu", *extra]
    ssim, rows = cli.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert "# Mesh: {'z': 2, 'y': 2, 'x': 2}" in out
    assert f"# Domains' devices: {['cpu'] * 8}" in out
    half = "--half_neigh" in extra
    ref = ShardedSimulation.from_input(_deck(8, nstat=100),
                                       devices=["cpu"] * 8, nbins=(4, 4, 4),
                                       half_neigh=half)
    ref.inp.ntimes = 20
    want = ref.thermo_trace(ref.run(20))
    assert rows == want and [r[0] for r in rows] == [0, 20]
    i = out.index("# Timestep T U P Time")
    assert out[i + 1].startswith("%d %e %e %e" % want[0])
    perf = next(ln for ln in out if "PERF_SUMMARY" in ln
                and not ln.startswith("#")).split()
    assert perf[:4] == ["8", "1", "20", "2048"]
    t_total, t_force, t_neigh, t_comm = (float(perf[k]) for k in
                                         (4, 5, 6, 7))
    if half:
        assert min(t_force, t_neigh, t_comm) > 0
        assert t_force + t_neigh + t_comm <= t_total
        path = next(ln for ln in out if ln.startswith("# YAML report: "))
        text = (tmp_path / path.split(": ", 1)[1]).read_text()
        lines = text.splitlines()
        assert "lost_atoms: 0" in lines and "  mpi_processes: 8" in lines
        assert "  half_neighbor: 1" in lines
        for key in ("atoms_per_device", "swap_atoms_z_per_device",
                    "time_comm_per_device", "time_neigh_intervals"):
            assert f"  {key}:" in lines, key
        assert "  ghost_cells_per_device: 56" in lines
    else:
        assert t_force == t_neigh == t_comm == 0.0
        assert not list(tmp_path.glob("*.yaml"))
    assert "# WARNING" not in "\n".join(out)


def test_devices_placement():
    """--device cpu puts every domain on the CPU; --device cuda puts them
    on the visible cards in turn, and without a card the CLI exits with
    an error instead of running on the CPU."""
    assert mesh_devices(3, "cpu") == ["cpu"] * 3
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert mesh_devices(3, "cuda") == [f"cuda:{i % n}" for i in range(3)]
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mesh_devices(3, "cuda")
    with pytest.raises(SystemExit) as exc:
        cli.main(["-s", "4", "--devices", "2", "--device", "cuda"])
    assert "no CUDA card" in str(exc.value.code)


def test_dryrun_multichip_cpu(capsys):
    """The dryrun_multichip counterpart: 16,384 LJ atoms on 8 domains,
    migrating at both of its 2 steps."""
    ssim = dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("dryrun_multichip(8) ok: mesh={'z': 2, 'y': 2, "
                          "'x': 2}")
    assert ssim.geom.nb == (8, 8, 8) and ssim.inp.neigh_every == 1
