"""minimd_torch Simulation on the CPU: golden rows, the reference's
statistical acceptance, the whole LJ and EAM slices against minimd_tpu
f64, grow-and-replay, the jax-free import and the CLI."""

import dataclasses
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
from minimd_torch.config import FORCE_EAM, FORCE_LJ
from minimd_torch.sim import Simulation, force_path, rebin_path
from minimd_torch.state import (geometry_from_reference, init_state,
                                state_from_reference)

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
from minimd_torch.ops.eam_rows_cuda import make_eam_force_rows_cuda
for deck, fused in (("lj", False), ("eam", False), ("lj", True)):
    inp = minimd_torch.builtin_deck(deck)
    inp.nx = inp.ny = inp.nz = 6
    sim = Simulation.from_input(inp, dtype=torch.float32, device="cpu",
                                fused_step=fused)
    trace = sim.run(20)
    assert trace.shape == (20, 3) and sim.state.overflow == 0
    print("ROW", deck, *sim.thermo_trace(trace)[-1])
    if deck == "eam":
        f, eng, vir = make_eam_force_rows_cuda(sim.geom, sim.tables,
                                               device="cpu")[0](
            sim.state.x, sim.state.typ)
        assert bool(torch.isfinite(f).all()) and float(eng) < 0.0
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
    assert [r[0] for r in rows] == ["lj", "eam", "lj"]
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


@pytest.mark.parametrize("argv", [["--devices", "2"],
                                  ["--devices", "4", "--half_neigh", "1"],
                                  ["--devices", "8", "--timed"],
                                  ["--backend", "xla"],
                                  ["--backend", "pallas", "-o", "1"]])
def test_cli_refuses_unported_flags(argv, capsys):
    """The JAX CLI's --backend (ROADMAP queue 1 item 11: the port has no
    backend switch) exits with the item named. --devices N, refused until
    the decomposed run was ported, now runs: here on N CPU domains, 10
    steps, with its PERF_SUMMARY line (the rest of the surface:
    test_torch_cli.py, test_torch_parallel_surface.py)."""
    if "--backend" not in argv:
        n = int(argv[1])
        ssim, rows = cli.main(["-s", "6", "-n", "10", "--device", "cpu",
                               *argv])
        assert ssim.mesh.size == n and [r[0] for r in rows] == [0, 10]
        assert ssim.half_neigh == ("--half_neigh" in argv)
        out = capsys.readouterr().out
        assert f"\n{n} 1 10 864 " in out and "PERF_SUMMARY" in out
        return
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


@pytest.mark.parametrize("what", ["half_neigh"])
def test_from_input_refuses_unported(what):
    """half_neigh is ported (tests/test_torch_half.py); what stays refused
    with it is the fused step, with the ValueError of
    minimd_tpu/sim.py:163-168."""
    with pytest.raises(ValueError, match="fused_step"):
        Simulation.from_input(_deck(6), device="cpu", fused_step=True,
                              **{what: True})


F32, F64 = torch.float32, torch.float64
# (forcetype, on the card, dtype, stencil reach, uniform LJ, half_neigh):
# the path minimd_tpu/sim.py picks on its accelerator (card) or CPU:
# half_neigh first (:177-185 LJ, :203-210 EAM); LJ through the kernel
# when _use_pallas (:267-282: f32, uniform, reach 1, not the CPU), else
# lj_grid (:186-189); EAM through the kernel for f32 at reach 1 on the
# accelerator (:211-227), eam_grid for f32 at reach > 1 there (:228-231),
# else the exact spline (:232-234)
FORCE_PATHS = [
    (FORCE_LJ, True, F32, 1, True, False, "lj_cuda"),
    (FORCE_LJ, True, F64, 1, True, False, "lj_grid"),
    (FORCE_LJ, True, F32, 2, True, False, "lj_grid"),
    (FORCE_LJ, True, F32, 1, False, False, "lj_grid"),
    (FORCE_LJ, False, F32, 1, True, False, "lj_grid"),
    (FORCE_LJ, False, F64, 2, False, False, "lj_grid"),
    (FORCE_LJ, True, F32, 1, True, True, "lj_half"),
    (FORCE_LJ, False, F64, 1, True, True, "lj_half"),
    (FORCE_EAM, True, F32, 1, True, False, "eam_cuda"),
    (FORCE_EAM, True, F32, 2, True, False, "eam_grid"),
    (FORCE_EAM, True, F64, 1, True, False, "eam"),
    (FORCE_EAM, True, F64, 2, True, False, "eam"),
    (FORCE_EAM, False, F32, 1, True, False, "eam"),
    (FORCE_EAM, False, F64, 2, True, False, "eam"),
    (FORCE_EAM, True, F32, 1, True, True, "eam_half"),
]


@pytest.mark.parametrize("forcetype,cuda,dtype,reach,uniform,half,want",
                         FORCE_PATHS)
def test_force_path_follows_the_jax_selection(forcetype, cuda, dtype, reach,
                                              uniform, half, want,
                                              monkeypatch):
    """Simulation's choice of force path, for each case of
    minimd_tpu/sim.py; the LJ kernel cases also against the JAX package's
    own _use_pallas, its backend reported as "tpu" for the card."""
    got = force_path(forcetype, cuda=cuda, dtype=dtype, reach=reach,
                     uniform=uniform, half_neigh=half)
    assert got == want
    if forcetype == FORCE_LJ and not half:
        from minimd_tpu import sim as jsim
        from minimd_tpu.ops.lj import LJParams as JLJParams

        monkeypatch.setattr(jsim.jax, "default_backend",
                            lambda: "tpu" if cuda else "cpu")
        inp = _deck(6)
        prd, x, _, _, _ = create.setup_system(inp)
        geom = jcells.build_geometry(prd, inp.neigh_cut, x,
                                     nbins=(3, 3, 3) if reach == 1
                                     else (6, 6, 6))
        assert int(np.abs(geom.stencil).max()) == reach
        eps = [1.0, 1.0, 1.0, 1.0 if uniform else 0.5]
        params = JLJParams(2, np.array(eps), np.ones(4), np.full(4, 6.25))
        assert params.uniform == uniform
        jdtype = jnp.float32 if dtype == F32 else jnp.float64
        assert jsim.Simulation._use_pallas(geom, params, jdtype, "auto") \
            == (got == "lj_cuda")


def test_card_force_paths_outside_the_kernels(monkeypatch):
    """Simulation._make_force as on the card (cuda=True) builds, outside
    the kernels' envelope, the plain closures the JAX package runs on its
    accelerator, and they run here on CPU tensors: float64 LJ on the LJ
    grid and float32 EAM at stencil reach 2 on the EAM grid, each equal
    to its plain factory's; a fused step past cells.MAX_CAPACITY is no
    longer refused on the card: it builds the LJ and fused-step kernels,
    whose closures equal the plain versions on CPU tensors."""
    from minimd_torch.cells import MAX_CAPACITY
    from minimd_torch.ops.eam_grid import make_eam_force_grid
    from minimd_torch.ops.lj_grid import make_lj_force_grid

    lj = Simulation.from_input(_deck(6), dtype=F64, device="cpu")
    want = make_lj_force_grid(lj.geom, lj.params, F64, "cpu")
    got = lj._make_force(lj.geom, cuda=True)
    eam = Simulation.from_input(_deck(6, "eam"), device="cpu",
                                nbins=(6, 6, 6))
    assert np.abs(eam.geom.stencil).max() == 2
    want_eam = make_eam_force_grid(eam.geom, eam.tables, F32, "cpu")
    got_eam = eam._make_force(eam.geom, cuda=True)
    for sim, pair in ((lj, zip(got, want)), (eam, zip(got_eam, want_eam))):
        x, typ = sim.state.x, sim.state.typ
        for g, w in pair:
            assert all(torch.equal(a, b) for a, b in zip(g(x, typ),
                                                         w(x, typ)))
    fused = Simulation.from_input(_deck(2), device="cpu", fused_step=True,
                                  nbins=(1, 1, 1))
    big = dataclasses.replace(fused.geom, capacity=MAX_CAPACITY + 8)
    made = _spy_kernel_factories(monkeypatch)
    st = init_state(*_lattice_arrays(_deck(2)), big, dtype=F32)
    got_f = fused._make_force(big, cuda=True)
    want_f = make_lj_force_grid(big, fused.params, F32, "cpu")
    for g, w in zip(got_f, want_f):
        assert all(torch.equal(a, b) for a, b in zip(g(st.x, st.typ),
                                                     w(st.x, st.typ)))
    _equal_steps(fused, big, st)
    assert made == ["lj_force", "lj_step"]


def _lattice_arrays(inp):
    """(x, v, typ) of a deck's lattice, as numpy arrays."""
    _, x, v, typ, _ = create.setup_system(inp)
    return x, v, typ


def _spy_kernel_factories(monkeypatch):
    """Records, in the list returned, the kernel wrappers' factories that
    Simulation calls (it imports them when it builds a path), each still
    making its closures."""
    from minimd_torch.ops import eam_cuda, lj_cuda, lj_step_cuda, rebin_cuda

    made = []
    for mod, name, key in ((lj_cuda, "make_lj_force_cuda", "lj_force"),
                           (eam_cuda, "make_eam_force_cuda", "eam_force"),
                           (lj_step_cuda, "make_lj_step_cuda", "lj_step"),
                           (rebin_cuda, "make_rebin_cuda", "rebin")):
        def spy(*args, _make=getattr(mod, name), _key=key, **kw):
            made.append(_key)
            return _make(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    return made


def _equal_steps(sim, geom, st):
    """The fused step _make_step builds for `geom` as on the card, against
    make_lj_step_plain's, over two chained steps from the seed: equal."""
    from minimd_torch.ops.lj_step import make_lj_step_plain

    got = sim._make_step(geom, cuda=True)
    want = make_lj_step_plain(geom, sim.params, sim.inp.dt, sim.dtforce,
                              F32, "cpu")
    f = sim._make_force(geom, cuda=False)[0](st.x, st.typ)[0]
    outs = []
    for step, seed in (got, want):
        x, w = seed(st.x.clone(), st.v.clone(), f)
        for evflag in (True, False):
            x, w, *rest = step(x, w, evflag)
        outs.append((x, w, *rest))
    for a, b in zip(*outs):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("deck", ["lj", "eam"])
@pytest.mark.parametrize("over", [0, 8], ids=["512", "520"])
def test_card_runs_the_kernels_past_512(deck, over, monkeypatch):
    """The capacity is no term of the path choice, as in the JAX package:
    with cuda=True, at C = cells.MAX_CAPACITY and at MAX_CAPACITY + 8,
    Simulation builds the LJ or EAM kernels, the rebin kernels and (LJ)
    the fused-step kernel, whose closures run here on CPU tensors and
    equal their plain versions' outputs."""
    from minimd_torch import cells
    from minimd_torch.ops.eam_grid import make_eam_force_grid
    from minimd_torch.ops.lj_grid import make_lj_force_grid

    lj = deck == "lj"
    inp = _deck(2, deck)    # one cell of reach 1: few pairs at C = 520
    sim = Simulation.from_input(inp, device="cpu", nbins=(1, 1, 1),
                                fused_step=lj)
    geom = dataclasses.replace(sim.geom,
                               capacity=cells.MAX_CAPACITY + over)
    # the rebin kernels need 3 cells an axis (rebin_lean below)
    grid3 = cells.build_geometry(sim.geom.prd, inp.neigh_cut,
                                 _lattice_arrays(inp)[0], nbins=(3, 3, 3),
                                 capacity=geom.capacity)
    assert int(np.abs(geom.stencil).max()) == 1
    ft = FORCE_LJ if lj else FORCE_EAM
    assert force_path(ft, cuda=True, dtype=F32, reach=1) == f"{deck}_cuda"
    assert rebin_path(grid3, cuda=True, dtype=F32) == "rebin_cuda"
    assert rebin_path(grid3, cuda=True, dtype=F64) == "rebin_local"
    assert rebin_path(grid3, cuda=False, dtype=F32) == "rebin_local"
    assert rebin_path(geom, cuda=True, dtype=F32) == "rebin_lean"
    made = _spy_kernel_factories(monkeypatch)
    st = init_state(*_lattice_arrays(inp), geom, dtype=F32)
    model = sim.params if lj else sim.tables
    make = make_lj_force_grid if lj else make_eam_force_grid
    for g, w in zip(sim._make_force(geom, cuda=True),
                    make(geom, model, F32, "cpu")):
        assert all(torch.equal(a, b) for a, b in zip(g(st.x, st.typ),
                                                     w(st.x, st.typ)))
    st3 = init_state(*_lattice_arrays(inp), grid3, dtype=F32)
    xp = st3.x + 0.3
    got = sim._make_rebin(grid3, cuda=True)(xp, st3.v, st3.typ)
    want = cells.rebin_local(xp, st3.v, st3.typ, grid3)
    assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
               for a, b in zip(got, want))
    if lj:
        _equal_steps(sim, geom, st)
    assert made == [f"{deck}_force", "rebin"] + (["lj_step"] if lj else [])


def test_growth_follows_the_jax_package():
    """A capacity overflow grows the cells to next_capacity(C) with no
    clamp, as minimd_tpu/sim.py:724-730 grows them: 10 atoms drifting
    into a cell that holds C = 480 regrow the layout to next_capacity(480)
    = 600 (past cells.MAX_CAPACITY), and the run replays with every
    atom; at C = MAX_CAPACITY the same overflow raises, as the JAX
    package raises at C >= MAX_CAPACITY."""
    from minimd_torch import cells

    assert cells.next_capacity(480) == jcells.next_capacity(480) == 600
    inp = _deck(4)          # a 6.72 sigma box: two cells of reach 1
    inp.epsilon = 0.0       # no forces: the atoms drift as they are sent
    inp.neigh_every = inp.thermo_nstat = 2
    prd, _, _, _, mass = create.setup_system(inp)
    rng = np.random.default_rng(0)
    for cap in (480, cells.MAX_CAPACITY):
        # C atoms at rest in the lower cell along x, 10 more just above
        # it moving down into it (0.02 sigma a rebin interval)
        x = rng.uniform(0.02, 0.98, (cap + 10, 3)) * np.asarray(prd)
        x[:, 0] = x[:, 0] * 0.48
        x[cap:, 0] = 0.5 * prd[0] + 0.005
        v = np.zeros_like(x)
        v[cap:, 0] = -2.0
        # the cells' faces at x = 0 and prd/2 (no clearance offset)
        geom = dataclasses.replace(cells.build_geometry(
            prd, inp.neigh_cut, x, nbins=(2, 1, 1), capacity=cap),
            offset=(0.0, 0.0, 0.0))
        st = init_state(x, v, np.zeros(cap + 10, np.int32), geom, F64)
        sim = Simulation.from_state(inp, geom, st, mass, dtype=F64,
                                    device="cpu")
        sim._user_nbins, sim._user_capacity = geom.nb, cap
        assert sim.geom.capacity == cap and sim.state.overflow == 0
        if cap >= cells.MAX_CAPACITY:
            with pytest.raises(RuntimeError, match="capacity overflow"):
                sim.run(4)
            continue
        trace = sim.run(4)
        assert sim.geom.capacity == 600 and sim.geom.nb == (2, 1, 1)
        assert sim._regrows == 1 and sim.state.overflow == 0
        assert int(sim.state.valid.sum()) == cap + 10
        assert np.isfinite(trace).all()
