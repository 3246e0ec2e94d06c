"""minimd_torch.parallel, the spatially decomposed run, on the CPU at
float64 against minimd_tpu.parallel and the port's single-device path:
the mesh and the grid that divides it, the halo exchange, the forces on
the domains, the migration, whole LJ and EAM runs, grow-and-replay and
the state carried across. The meshes are lists of CPU domains
(devices=["cpu"] * k); the JAX package runs on the conftest's 8 virtual
CPU devices."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from minimd_tpu import cells as jcells
from minimd_tpu import create as jcreate
from minimd_tpu.config import builtin_deck as jdeck
from minimd_tpu.ops import pairgrid as jpairgrid
from minimd_tpu.parallel import ShardedSimulation as JaxSharded
from minimd_tpu.parallel import comm as jcomm
from minimd_tpu.parallel import mesh as jmesh
from minimd_torch import cells, create
from minimd_torch.config import builtin_deck
from minimd_torch.ops.eam import EAMTables
from minimd_torch.ops.eam_cuda import make_eam_pair_cuda, make_eam_rho_cuda
from minimd_torch.ops.eam_grid import make_eam_force_grid
from minimd_torch.ops.lj import LJParams
from minimd_torch.ops.lj_cuda import make_lj_force_cuda
from minimd_torch.ops.lj_grid import make_lj_force_grid
from minimd_torch.ops.pairgrid import halo_extent, pad_grid_int, to_padded_soa
from minimd_torch.ops.rebin_cuda import make_rebin_cuda
from minimd_torch.parallel import ShardedSimulation, comm, mesh, step
from minimd_torch.sim import Simulation
from minimd_torch.state import (init_state, sharded_from_grid,
                                sharded_to_grid)

torch.set_num_threads(2)
F64 = torch.float64


def _domains(grid):
    """A (px, py, pz) mesh of CPU domains and its router."""
    m = mesh.make_mesh(["cpu"] * int(np.prod(grid)), (1.0, 1.0, 1.0), grid)
    return m, mesh.Router(m)


def _system(s, nbins, deck="lj", ntypes=1, kick=0.0, seed=3,
            capacity=None):
    """(inp, geom, MDState) at float64: the deck's lattice of s^3 cells,
    ntypes types (create.assign_types), each coordinate kicked by up to
    +-kick, laid out by init_state on the grid nbins (and capacity)."""
    inp = builtin_deck(deck)
    inp.nx = inp.ny = inp.nz = s
    prd, x, v, typ, _ = create.setup_system(inp, ntypes, None)
    if ntypes == 1:
        typ = np.zeros(len(x), np.int32)
    x = x + kick * np.random.default_rng(seed).uniform(-1, 1, x.shape)
    x = np.mod(x, prd)
    geom = cells.build_geometry(prd, inp.neigh_cut, x, nbins=nbins,
                                capacity=capacity)
    return inp, geom, init_state(x, v, typ, geom, dtype=F64)


def _grid(t, geom):
    nbx, nby, nbz = geom.nb
    lead = (3,) if t.dim() == 2 else ()
    return t.reshape(lead + (nbz, nby, nbx, geom.capacity))


def _split(st, geom, m, f=None):
    return sharded_from_grid(*(_grid(t, geom) for t in (
        st.x, st.v, st.x * 0 if f is None else f, st.typ, st.valid)),
        m, geom, F64)


# ----------------------------------------------------------------------
# mesh and grid
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,prd", [
    (8, (10.0, 10.0, 10.0)), (4, (10.0, 10.0, 80.0)), (7, (10.0, 10.0, 10.0)),
    (12, (20.0, 10.0, 10.0)), (6, (5.0, 30.0, 12.0)), (1, (3.0, 4.0, 5.0))])
def test_min_surface_grid_matches_jax(n, prd):
    assert mesh.min_surface_grid(n, prd) == jmesh.min_surface_grid(n, prd)
    m = mesh.make_mesh(["cpu"] * n, prd)
    px, py, pz = mesh.min_surface_grid(n, prd)
    assert m.shape == {"z": pz, "y": py, "x": px} and m.size == n
    for k in range(n):
        assert m.domain(m.coord(k)) == k
        assert m.ring(m.ring(k, "x", 1), "x", -1) == k


@pytest.mark.parametrize("s,mult", [(10, (2, 2, 2)), (24, (2, 2, 2)),
                                    (24, (4, 2, 1)), (10, (1, 1, 1)),
                                    (10, (5, 1, 1)), (10, (4, 1, 1))])
def test_autotune_multiple_of(s, mult):
    """Equal to the JAX version where no candidate is snapped up; where
    the mesh has more domains than the deck has cells on an axis, the port
    never returns binsize < cutneigh (it skips the candidate, or raises)."""
    inp = jdeck("lj")
    box = jcreate.create_box(s, s, s, inp.rho)
    x, _ = jcreate.create_atoms(s, s, s, inp.rho, box)
    base = np.floor(np.asarray(box.prd) / inp.neigh_cut).astype(int)
    snaps_up = any(int(np.floor(b * f)) < m for b, m in zip(base, mult)
                   for f in (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65,
                             0.6))
    try:
        got = cells.autotune_grid(box.prd, inp.neigh_cut, x,
                                  multiple_of=mult)
    except ValueError as e:
        assert any(b < m for b, m in zip(base, mult)), e
        return
    assert all(g % m == 0 for g, m in zip(got, mult))
    assert all(p / g >= inp.neigh_cut for p, g in zip(box.prd, got))
    if not snaps_up:
        assert got == jcells.autotune_grid(box.prd, inp.neigh_cut, x,
                                           multiple_of=mult)


# ----------------------------------------------------------------------
# halo exchange
# ----------------------------------------------------------------------

# mesh (px, py, pz), grid, and the stencil reach h against the span L
HALO_CASES = {"222": ((2, 2, 2), (4, 4, 4)), "421": ((4, 2, 1), (4, 4, 4)),
              "811": ((8, 1, 1), (8, 4, 4)),         # L = 1 < h = 2
              "141-h3": ((1, 4, 1), (4, 12, 4))}     # L = 3 = h


@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_matches_global_padded_grid(case):
    """Each domain's padded grid from the exchange (pairgrid hooks and the
    run's gathers) is bit for bit the slice of the JAX package's periodic
    padded grid of the whole box, positions and types."""
    grid, nbins = HALO_CASES[case]
    _, geom, st = _system(8, nbins, ntypes=4, kick=0.1)
    h = halo_extent(geom)
    m, router = _domains(grid)
    nl = step.local_grid_shape(geom, m)
    if case == "811":
        assert h > nl[0]
    ss = _split(st, geom, m)
    xs, ts = router.split(ss.x), router.split(ss.typ)
    ex = step.make_exchanges(m, geom.prd, h, nl)
    hooked = to_padded_soa(xs, geom, h, nb_local=nl, exchanges=ex)
    hooked_t = pad_grid_int(ts, geom, h, nb_local=nl, exchanges=ex)
    jgeom = jcells.CellGeometry(**{k: getattr(geom, k) for k in (
        "nb", "binsize", "capacity", "stencil", "cand_cell", "cand_shift",
        "prd", "offset")})
    ref = [np.asarray(g) for g in jpairgrid.to_padded_soa(
        jnp.asarray(st.x.numpy()), jgeom, h)]
    ref_t = np.asarray(jpairgrid.pad_grid_int(jnp.asarray(st.typ.numpy()),
                                              jgeom, h))
    halo = step.Halo(geom, m, router, h, nl, F64, wrap=True)
    gathered = router.split(halo.positions(ss.x))
    gathered_t = router.split(halo.scalars(ss.typ))
    lx, ly, lz = nl
    for k in range(m.size):
        c = m.coord(k)
        sl = (slice(c["z"] * lz, c["z"] * lz + lz + 2 * h),
              slice(c["y"] * ly, c["y"] * ly + ly + 2 * h),
              slice(c["x"] * lx, c["x"] * lx + lx + 2 * h))
        for d in range(3):
            np.testing.assert_array_equal(hooked[k][d].numpy(), ref[d][sl])
            assert torch.equal(gathered[k][d], hooked[k][d].reshape(-1))
        np.testing.assert_array_equal(hooked_t[k].numpy(), ref_t[sl])
        assert torch.equal(gathered_t[k], hooked_t[k].reshape(-1))


# ----------------------------------------------------------------------
# forces on the domains
# ----------------------------------------------------------------------

def _per_type_params():
    eps = np.array([1.0, 0.8, 1.2, 0.9, 0.8, 1.1, 0.7, 1.0, 1.2, 0.7, 1.3,
                    0.9, 0.9, 1.0, 0.9, 1.05])
    sig = np.array([1.0, 0.95, 1.05, 1.0] * 4)
    return LJParams(4, eps, sig ** 6, np.full(16, 2.5 ** 2))


@pytest.mark.parametrize("kind,grid", [("lj", (2, 2, 2)), ("lj", (4, 2, 1)),
                                       ("lj-types", (2, 2, 2)),
                                       ("eam", (1, 2, 2)), ("eam", (2, 2, 2))])
def test_domain_forces_match_single_device(kind, grid):
    """Per atom, every domain's force (the run's plain path, and the CPU
    twins of the sharded kernel wrappers on the kernels' padded input)
    is bit for bit the single-device plain force on the same cells; the
    energy and virial summed over the domains to 1e-13 relative."""
    deck = "eam" if kind == "eam" else "lj"
    _, geom, st = _system(8, (4, 4, 4), deck=deck, ntypes=4, kick=0.05)
    assert halo_extent(geom) == 1
    from minimd_torch.config import FORCE_EAM, FORCE_LJ
    if deck == "lj":
        model = (_per_type_params() if kind == "lj-types"
                 else LJParams.from_deck(4, 1.0, 1.0, 2.5))
        fev = make_lj_force_grid(geom, model, F64)[0]
        ftype = FORCE_LJ
    else:
        model = EAMTables.from_funcfl()
        fev = make_eam_force_grid(geom, model, F64)[0]
        ftype = FORCE_EAM
    f_ref, e_ref, w_ref = fev(st.x, st.typ)
    m, router = _domains(grid)
    nl = step.local_grid_shape(geom, m)
    ss = _split(st, geom, m)
    force = step.make_domain_force(ftype, geom, model, m, router, nl, F64)
    fs, es, ws = force(ss.x, ss.typ, True)
    got = sharded_to_grid(ss.__class__(ss.x, ss.v, fs, ss.typ, ss.valid),
                          m, geom)[2].reshape(3, -1)
    np.testing.assert_array_equal(got, f_ref.numpy())
    for a, b in ((router.domain_sum(es), e_ref), (router.domain_sum(ws),
                                                   w_ref)):
        assert abs(float(a) - float(b)) <= 1e-13 * abs(float(b))
    if kind == "lj-types":
        return
    # the sharded kernel wrappers' plain twins, on the kernels' input
    kh = step.Halo(geom, m, router, 1, nl, F64, wrap=False)
    xk = router.split(kh.positions(ss.x))
    fk = []
    if deck == "lj":
        # the wrappers take float32 only; their plain twins (lj_pair_loop
        # on plain_padded) are dtype-generic
        from minimd_torch.ops.pairgrid import plain_padded
        from minimd_torch.ops.lj_grid import lj_pair_loop
        for k in range(m.size):
            fg, _, _ = lj_pair_loop(plain_padded(geom, nl, m.decomposed,
                                                 xk[k]),
                                    None, geom, model, F64, True,
                                    nb_local=nl)
            fk.append(torch.stack([t.reshape(-1) for t in fg]))
    else:
        from minimd_torch.ops.eam_cuda import _interior_valid
        from minimd_torch.ops.eam_grid import (make_eam_pair_grid,
                                               make_eam_rho_grid)
        from minimd_torch.ops.pairgrid import plain_padded
        rho_p = make_eam_rho_grid(geom, model, F64, nb_local=nl, padded=True)
        pair_p = make_eam_pair_grid(geom, model, F64, nb_local=nl,
                                    padded=True)
        fps = []
        for k in range(m.size):
            Xp = plain_padded(geom, nl, m.decomposed, xk[k])
            fps.append(rho_p(Xp, _interior_valid(geom, nl, Xp), True)[1])
        fpk = router.split(kh.scalars(router.stack(fps)))
        for k in range(m.size):
            fk.append(pair_p(plain_padded(geom, nl, m.decomposed, xk[k]),
                             plain_padded(geom, nl, m.decomposed, fpk[k],
                                          coord=False), True)[0])
    got_k = sharded_to_grid(ss.__class__(ss.x, ss.v, router.stack(fk),
                                         ss.typ, ss.valid), m, geom)[2]
    np.testing.assert_array_equal(got_k.reshape(3, -1), f_ref.numpy())


def test_sharded_wrappers_cpu_twins():
    """The sharded LJ wrapper on CPU tensors runs the plain twin above:
    float32 forces equal the run's plain path's; the sharded rebin needs
    3 cells on the axes that wrap."""
    _, geom, st = _system(8, (4, 4, 4), ntypes=1, kick=0.05)
    x32 = st.x.float()
    m, router = _domains((1, 2, 2))
    nl = step.local_grid_shape(geom, m)
    ss = sharded_from_grid(*(_grid(t, geom) for t in (
        x32, st.v.float(), x32 * 0, st.typ, st.valid)), m, geom)
    params = LJParams.from_deck(1, 1.0, 1.0, 2.5)
    kh = step.Halo(geom, m, router, 1, nl, torch.float32, wrap=False)
    X = kh.positions(ss.x)[0]          # every domain, one launch on a card
    fev = make_lj_force_cuda(geom, params, nb_local=nl,
                             decomposed=m.decomposed, device="cpu")[0]
    from minimd_torch.config import FORCE_LJ
    force = step.make_domain_force(FORCE_LJ, geom, params, m, router, nl,
                                   torch.float32)
    want, e_want, w_want = force(ss.x, ss.typ, True)
    out = torch.empty_like(want[0])
    f, e, w = fev(X, None, out=out)
    assert f is out and torch.equal(f, want[0])
    assert torch.equal(e, e_want[0]) and torch.equal(w, w_want[0])
    with pytest.raises(ValueError):
        make_rebin_cuda(geom, "cpu", nb_local=(2, 2, 2),
                        decomposed=(False, True, True))


# ----------------------------------------------------------------------
# migration
# ----------------------------------------------------------------------

# (mesh, grid, buf_cap, hops, teleport)
MIGRATION_CASES = {
    "drift": ((2, 2, 2), (4, 4, 4), None, 1, False),
    "teleporter": ((2, 2, 2), (6, 6, 6), None, 1, True),
    "small-buffer": ((2, 2, 2), (4, 4, 4), 8, 1, False),
    "hops4-ring8": ((8, 1, 1), (8, 4, 4), None, 4, False),
}


def _jax_exchange(geom, grid, buf_cap, hops, arrays):
    jm = jmesh.make_mesh(jax.devices()[:8], geom.prd, grid)
    jgeom = jcells.CellGeometry(**{k: getattr(geom, k) for k in (
        "nb", "binsize", "capacity", "stencil", "cand_cell", "cand_shift",
        "prd", "offset")})
    ex = jcomm.make_exchange_rebin(jgeom, jm, jnp.float64, buf_cap=buf_cap,
                                   hops=hops)
    spec, spec1 = P(None, "z", "y", "x", None), P("z", "y", "x", None)

    def f(x, v, t, ok):
        gs, g1 = x.shape, t.shape
        xo, vo, to, oko, ovf = ex(x.reshape(3, -1), v.reshape(3, -1),
                                  t.reshape(-1), ok.reshape(-1))
        return (xo.reshape(gs), vo.reshape(gs), to.reshape(g1),
                oko.reshape(g1), ovf[None])

    fn = jax.jit(jax.shard_map(
        f, mesh=jm, in_specs=(spec, spec, spec1, spec1),
        out_specs=(spec, spec, spec1, spec1, P(("z", "y", "x")))))
    return [np.asarray(a) for a in fn(*(jnp.asarray(a) for a in arrays))]


@pytest.mark.parametrize("case", list(MIGRATION_CASES))
def test_exchange_rebin_matches_jax(case):
    """x (in the occupied slots), v, typ, valid and the per-domain
    [movement, capacity, buffer] overflow bit for bit the JAX
    make_exchange_rebin under shard_map; the card form's sentinel input
    (kernel=True, its plain twin here) too."""
    grid, nbins, buf_cap, hops, teleport = MIGRATION_CASES[case]
    _, geom, st = _system(8, nbins, ntypes=4)
    x = st.x.clone()
    rng = np.random.default_rng(11)
    valid = st.valid.numpy()
    # drift: every atom up to 0.6 sigma (a third of a cell or more), so
    # many cross domains; hops=4: a few atoms moved 2-4 domains along x
    x[:, valid] += torch.as_tensor(rng.uniform(-0.6, 0.6, (3, valid.sum())))
    if hops > 1:
        idx = np.flatnonzero(valid)[:40:4]
        x[0, idx] += torch.as_tensor(rng.integers(2, 5, len(idx)) * 1.68)
    if teleport:   # moved 2 cells within its domain: movement overflow
        i = int(np.flatnonzero(valid)[0])
        x[:, i] = x[:, i] + torch.as_tensor(
            [2.0 * geom.binsize[0], 0.0, 0.0], dtype=F64)
        x[0, i] = torch.minimum(x[0, i], torch.tensor(geom.prd[0] - 1e-3))
    st.v[:, ~st.valid] = 0.0
    arrays = [_grid(t, geom).numpy() for t in (x, st.v, st.typ, st.valid)]
    jx, jv, jt, jok, jovf = _jax_exchange(geom, grid, buf_cap, hops, arrays)
    m, router = _domains(grid)
    nl = step.local_grid_shape(geom, m)
    ss = sharded_from_grid(*(_grid(t, geom) for t in (
        x, st.v, st.v, st.typ, st.valid)), m, geom, F64)
    for kernel in (False, True) if hops == 1 else (False,):
        ex = comm.make_exchange_rebin(geom, m, router, nl, F64,
                                      buf_cap=buf_cap, hops=hops,
                                      kernel=kernel)
        ox, ov, ot, ook, ovf = ex(ss.x, ss.v, ss.typ, ss.valid)
        gx, gv, _, gt, gok = sharded_to_grid(
            ss.__class__(ox, ov, ov, ot, ook), m, geom)
        for a, b in ((gv, jv), (gt, jt), (gok, jok)):
            np.testing.assert_array_equal(a, b)
        # positions bit for bit in the occupied slots; the empty ones hold
        # sentinels distinct across all domains, where the JAX package
        # repeats sentinel_positions(M_local) in every domain
        np.testing.assert_array_equal(gx[:, gok], jx[:, jok])
        empty = gx[0][~gok]
        assert (empty >= cells.VALID_BELOW).all()
        assert len(np.unique(empty)) == empty.size
        got_ovf = np.stack([o.numpy() for o in router.split(ovf)])
        np.testing.assert_array_equal(got_ovf, jovf)
    total = jovf.sum(axis=0)
    if case == "teleporter":
        assert total[0] == 1
    if case == "small-buffer":
        assert total[2] > 0
    if case in ("drift", "hops4-ring8"):
        assert total.sum() == 0 and jok.sum() == valid.sum()


# ----------------------------------------------------------------------
# whole runs
# ----------------------------------------------------------------------

def _lj_deck(nstat=10):
    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 8
    inp.thermo_nstat = nstat
    return inp


# 2 cells a domain on each axis
LJ_GRID = (4, 4, 4)


@pytest.fixture(scope="module")
def lj_runs():
    """The JAX and the port's ShardedSimulation of the LJ deck at 2,048
    atoms on a (2,2,2) mesh, 100 steps (5 migrations), thermo every 10
    steps."""
    jinp = jdeck("lj")
    jinp.nx = jinp.ny = jinp.nz = 8
    jinp.thermo_nstat = 10
    js = JaxSharded.from_input(jinp, devices=jax.devices()[:8],
                               dtype=jnp.float64, nbins=LJ_GRID)
    jt = js.run(100)
    ts = ShardedSimulation.from_input(_lj_deck(), devices=["cpu"] * 8,
                                      dtype=F64, nbins=LJ_GRID)
    tt = ts.run(100)
    return js, jt, ts, tt


def test_sharded_lj_matches_jax(lj_runs):
    js, jt, ts, tt = lj_runs
    assert ts.geom.nb == js.geom.nb and ts.geom.capacity == js.geom.capacity
    assert ts.mesh.shape == dict(js.mesh.shape)
    jr, tr = js.thermo_trace(jt), ts.thermo_trace(tt)
    assert [r[0] for r in tr] == [r[0] for r in jr] == list(range(0, 101, 10))
    # step 0: the sums run in torch's order where the JAX package's run
    # in XLA's: equal as printed, and to 1e-13
    assert "%e %e %e" % tr[0][1:] == "%e %e %e" % jr[0][1:]
    np.testing.assert_allclose(tr[0][1:], jr[0][1:], rtol=1e-13, atol=0)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a[1:], b[1:], rtol=1e-10, atol=0)
    s_j, s_t = js.state, ts.state
    np.testing.assert_array_equal(s_t.typ.numpy(), s_j.typ)
    np.testing.assert_array_equal(s_t.valid.numpy(), s_j.valid)
    ok = s_j.valid
    for name in ("x", "v"):
        a = getattr(s_t, name).numpy()[:, ok]
        assert np.abs(a - getattr(s_j, name)[:, ok]).max() < 1e-10, name
    assert int(ok.sum()) == 2048


def test_sharded_step0_row_equals_simulation(lj_runs):
    """The step-0 row is the single-device Simulation's, to the bit."""
    _, _, ts, _ = lj_runs
    sim = Simulation.from_input(_lj_deck(), dtype=F64, device="cpu",
                                nbins=ts.geom.nb)
    assert ts.row0 == sim._row0


def test_sharded_eam_matches_single_device():
    """EAM on a (1,2,2) mesh (the fp halo between the passes; one cell a
    domain on y and z), 40 steps (2 migrations), against the
    single-device Simulation on the same polynomial force (the decomposed
    run's plain EAM), 1e-10 relative."""
    inp = builtin_deck("eam")
    inp.nx = inp.ny = inp.nz = 5
    inp.thermo_nstat = 10
    ts = ShardedSimulation.from_input(inp, devices=["cpu"] * 4, dtype=F64)
    assert ts.mesh.shape == {"z": 2, "y": 2, "x": 1}
    tt = ts.run(40)
    sim = Simulation.from_input(inp, dtype=F64, device="cpu",
                                nbins=ts.geom.nb)
    sim.force_fn, sim.force_fn_noev = make_eam_force_grid(
        sim.geom, sim.tables, F64, "cpu")
    sim._compute_initial_force()
    st = sim.run(40)
    a, b = ts.thermo_trace(tt), sim.thermo_trace(st)
    assert [r[0] for r in a] == [r[0] for r in b] == [0, 10, 20, 30, 40]
    for r, q in zip(a, b):
        np.testing.assert_allclose(r[1:], q[1:], rtol=1e-10, atol=0)
    assert ts.geom.nb == (3, 2, 2)
    assert int(ts.state.valid.sum()) == ts.natoms == 500


def _grow_sim(**opts):
    """864 LJ atoms on 2 domains, thermo every 20 steps, started at three
    times the deck's velocities, so that atoms cross the domains' faces
    from the first migration on."""
    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 6
    inp.thermo_nstat = 20
    prd, x, v, typ, mass = create.setup_system(inp, 1, None)
    return ShardedSimulation.from_arrays(
        inp, prd, x, 3.0 * v, typ, mass, devices=["cpu"] * 2, dtype=F64,
        nbins=(3, 3, 4), **opts)


@pytest.fixture(scope="module")
def grow_ref():
    """An uninterrupted 60-step run and its t=0 maximum cell occupancy."""
    ref = _grow_sim()
    occ = ref.state.valid.reshape(-1, ref.geom.capacity).sum(dim=1)
    return ref.thermo_trace(ref.run(60)), int(occ.max())


@pytest.mark.parametrize("what", ["capacity", "buffer"])
def test_grow_and_replay(what, grow_ref):
    """A capacity pinned at the t=0 maximum occupancy (or migration
    buffers of one slot) overflows; the run grows, replays from the
    pre-run state and ends as an uninterrupted run: every atom kept, the
    same rows."""
    want, tight = grow_ref
    sim = _grow_sim(**({"capacity": tight} if what == "capacity"
                       else {"exchange_buf_cap": 1}))
    got = sim.thermo_trace(sim.run(60))
    if what == "capacity":
        assert sim.geom.capacity > tight
    else:
        assert sim._buf_cap > 1
    assert int(sim.state.valid.sum()) == 864
    for r, q in zip(got, want):
        assert r[0] == q[0]
        np.testing.assert_allclose(r[1:], q[1:], rtol=1e-9, atol=0)


def test_state_round_trip(lj_runs):
    """A JAX ShardedSimulation's arrays carried into the port's domains
    and back, bit for bit; the port's run goes on from them."""
    js, _, ts, _ = lj_runs
    arrays = [np.asarray(a) for a in js.arrays]
    ss = sharded_from_grid(*arrays, ts.mesh, ts.geom, F64)
    back = sharded_to_grid(ss, ts.mesh, ts.geom)
    for a, b in zip(back, arrays):
        np.testing.assert_array_equal(a, b)
    clone = ss.clone()
    clone.x[0] += 1.0
    assert not torch.equal(clone.x[0], ss.x[0])


def _groups_deck(case):
    """(deck, nbins, steps, half_neigh) of a two-group case: LJ on 2 cells
    a domain (LJ_GRID), EAM on its autotuned grid, a migration every 5
    steps and a row every 5 in the short runs."""
    if case.startswith("lj"):
        return _lj_deck(), LJ_GRID, 40, case.endswith("half")
    inp = builtin_deck("eam")
    inp.nx = inp.ny = inp.nz = 5
    inp.neigh_every = inp.thermo_nstat = 5
    return inp, None, 10, case.endswith("half")


@pytest.mark.parametrize("case", ["lj", "lj-half", "eam", "eam-half"])
def test_device_groups_match_one_group(case):
    """Domains on two devices ("cpu:0" and "cpu:1" are two groups here,
    interleaved in domain order, as on two cards) run the copies between
    groups (each group receives only the slabs its halo reads, ships its
    Newton shells back to their owners, and receives its ring neighbors'
    leaver packs) and the domain-order sums: rows and the gathered state
    equal those of one group, bit for bit, on the full and the half
    (gn=1) paths, the fold summing each slot's images in one order
    whatever the groups."""
    inp, nbins, steps, half = _groups_deck(case)
    runs = [ShardedSimulation.from_input(inp, devices=devs, dtype=F64,
                                         nbins=nbins, half_neigh=half)
            for devs in (["cpu"] * 8, ["cpu:0", "cpu:1"] * 4)]
    assert [len(r.router.groups) for r in runs] == [1, 2]
    assert runs[1].mesh.order == [0, 2, 4, 6, 1, 3, 5, 7]
    a, b = (r.run(steps) for r in runs)
    np.testing.assert_array_equal(a, b)
    for k in ("x", "v", "f", "typ", "valid"):
        assert torch.equal(getattr(runs[0].state, k),
                           getattr(runs[1].state, k)), k
    assert int(runs[1].state.valid.sum()) == runs[1].natoms


def test_migration_ships_ring_neighbors_only():
    """The migration on a (4,2,1) mesh whose two groups hold the x halves
    (ix 0-1 on "cpu:0", 2-3 on "cpu:1"): bit for bit the one-group
    migration, and on every ring step each group receives the leaver
    packs of exactly the other group's domains that its own domains
    receive from: 2 of the 4 on the x ring, none on the y ring."""
    grid, nbins = (4, 2, 1), (8, 4, 4)
    _, geom, st = _system(8, nbins, ntypes=4)
    x = st.x.clone()
    valid = st.valid.numpy()
    rng = np.random.default_rng(11)
    x[:, valid] += torch.as_tensor(rng.uniform(-0.6, 0.6, (3, valid.sum())))
    outs, routers = [], []
    for devs in (["cpu"] * 8, ["cpu:0", "cpu:0", "cpu:1", "cpu:1"] * 2):
        m = mesh.make_mesh(devs, (1.0, 1.0, 1.0), grid)
        router = mesh.Router(m)
        nl = step.local_grid_shape(geom, m)
        ss = sharded_from_grid(*(_grid(t, geom) for t in (
            x, st.v, st.v, st.typ, st.valid)), m, geom, F64)
        ex = comm.make_exchange_rebin(geom, m, router, nl, F64)
        ox, ov, ot, ook, ovf = ex(ss.x, ss.v, ss.typ, ss.valid)
        outs.append(sharded_to_grid(ss.__class__(ox, ov, ov, ot, ook), m,
                                    geom) + (np.stack([o.numpy() for o in
                                                       router.split(ovf)]),))
        routers.append(router)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert outs[0][-1].sum() == 0 and outs[0][4].sum() == valid.sum()
    router = routers[1]
    assert [ks for _, ks in router.groups] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    m = router.mesh
    rings = {(a, j): tuple(m.ring(k, a, j) for k in range(8))
             for a in ("x", "y") for j in (1, -1)}
    # the y ring's two directions are one permutation of two domains
    assert set(router._routes) == set(rings.values())
    for src, (sends, _) in router._routes.items():
        x_ring = src in (rings["x", 1], rings["x", -1])
        for g, (_, ks) in enumerate(router.groups):
            want = sorted({src[k] for k in ks} - set(ks))
            got = sorted(router.groups[s][1][int(i)] for s, idx in sends[g]
                         for i in idx)
            assert got == want
            assert len(got) == (2 if x_ring else 0)


def test_sharded_wrappers_take_any_capacity():
    """Past C = cells.MAX_CAPACITY the sharded kernel wrappers are made
    as below it (the kernels take any capacity, as the JAX package's
    do): at C = 520 the sharded LJ wrapper on CPU tensors equals the
    decomposed run's plain forces, and the sharded EAM and rebin wrappers
    are made for the same domains."""
    from minimd_torch.config import FORCE_LJ

    _, geom, st = _system(6, (3, 2, 2), kick=0.05,
                          capacity=cells.MAX_CAPACITY + 8)
    x32 = st.x.float()
    m, router = _domains((1, 2, 2))
    nl = step.local_grid_shape(geom, m)
    ss = sharded_from_grid(*(_grid(t, geom) for t in (
        x32, st.v.float(), x32 * 0, st.typ, st.valid)), m, geom)
    params = LJParams.from_deck(1, 1.0, 1.0, 2.5)
    kh = step.Halo(geom, m, router, 1, nl, torch.float32, wrap=False)
    fev = make_lj_force_cuda(geom, params, nb_local=nl,
                             decomposed=m.decomposed, device="cpu")[0]
    force = step.make_domain_force(FORCE_LJ, geom, params, m, router, nl,
                                   torch.float32)
    want, e_want, w_want = force(ss.x, ss.typ, True)
    f, e, w = fev(kh.positions(ss.x)[0], None)
    assert torch.equal(f, want[0])
    assert torch.equal(e, e_want[0]) and torch.equal(w, w_want[0])
    tables = EAMTables.from_funcfl()
    for make in (make_eam_rho_cuda, make_eam_pair_cuda):
        make(geom, tables, nb_local=nl, decomposed=m.decomposed,
             device="cpu")
    make_rebin_cuda(geom, "cpu", nb_local=nl, decomposed=m.decomposed)


def test_surface_refusals():
    inp = _lj_deck()
    with pytest.raises(ValueError, match="cell_chunk"):
        ShardedSimulation.from_input(inp, devices=["cpu"] * 2, cell_chunk=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices"):
            ShardedSimulation.from_input(inp)
    with pytest.raises(ValueError, match="mesh"):
        ShardedSimulation.from_input(inp, devices=["cpu"] * 8,
                                     nbins=(1, 4, 4))
