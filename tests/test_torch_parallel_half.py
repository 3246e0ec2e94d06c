"""minimd_torch.parallel's half-neighbor paths (the Newton folds) on the
CPU at float64: the port's ShardedSimulation(half_neigh=True) against the
JAX package's sharded half-neighbor run (make_sharded_lj_run /
make_sharded_eam_run with half_neigh, the XLA loop its ShardedSimulation
runs) on the same arrays, against the port's one-device half path on a
mesh of one-cell spans, the fold as the exact adjoint of the halo fill,
and the refusals. Meshes are lists of CPU domains; the JAX package runs
on the conftest's virtual CPU devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from minimd_tpu import cells as jcells
from minimd_tpu.ops.eam import EAMTables as JEAMTables
from minimd_tpu.ops.lj import LJParams as JLJParams
from minimd_tpu.parallel import mesh as jmesh
from minimd_tpu.parallel.step import make_sharded_eam_run, make_sharded_lj_run
from minimd_tpu.units import thermo_scales as jthermo_scales
from minimd_torch import cells, create
from minimd_torch.config import builtin_deck
from minimd_torch.ops.lj import LJParams
from minimd_torch.ops.lj_half import PeriodicHalo
from minimd_torch.ops.pairgrid import halo_extent
from minimd_torch.parallel import ShardedSimulation, mesh, step
from minimd_torch.sim import Simulation
from minimd_torch.state import sharded_to_grid

torch.set_num_threads(2)
F64 = torch.float64


def _deck(deck, s, every=5, nstat=1):
    inp = builtin_deck(deck)
    inp.nx = inp.ny = inp.nz = s
    inp.neigh_every = every
    inp.thermo_nstat = nstat
    return inp


def _half(inp, ndom, nbins=None, gn=True):
    return ShardedSimulation.from_input(
        inp, devices=["cpu"] * ndom, dtype=F64, nbins=nbins,
        half_neigh=True, ghost_newton=gn)


def _jax_run(ts, steps, gn=True):
    """The JAX package's sharded half-neighbor run (backend "xla") from the
    port's state arrays, geometry and mesh shape: its (steps, 3) trace and
    overflow counts."""
    inp, geom = ts.inp, ts.geom
    jgeom = jcells.CellGeometry(**{
        f.name: getattr(geom, f.name)
        for f in jcells.dataclasses.fields(jcells.CellGeometry)})
    m = ts.mesh.shape
    jm = jmesh.make_mesh(jax.devices()[:ts.mesh.size], geom.prd,
                         (m["x"], m["y"], m["z"]))
    prd = geom.prd
    scales = jthermo_scales(inp.units, ts.natoms, prd[0] * prd[1] * prd[2])
    common = dict(mass=ts.mass, dt=inp.dt, dtforce=ts.dtforce,
                  natoms=ts.natoms, neigh_every=inp.neigh_every,
                  nstat=inp.thermo_nstat, dtype=jnp.float64, backend="xla",
                  half_neigh=True)
    if inp.forcetype == 0:
        params = JLJParams.from_deck(1, inp.epsilon, inp.sigma,
                                     inp.force_cut)
        run, sharding = make_sharded_lj_run(jgeom, params, jm, scales,
                                            ghost_newton=gn, **common)
    else:
        run, sharding = make_sharded_eam_run(
            jgeom, JEAMTables.from_funcfl(), jm, scales, **common)
    sh1 = NamedSharding(jm, P("z", "y", "x", None))
    x, v, f, typ, valid = sharded_to_grid(ts.state_, ts.mesh, geom)
    args = [jax.device_put(a, sharding) for a in (x, v, f)]
    args += [jax.device_put(a, sh1) for a in (typ, valid)]
    *_, ovf, trace = run(*args, steps)
    return np.asarray(trace), np.asarray(ovf)


# (deck, size, domains, grid, ghost_newton, steps, rtol T, U, P): LJ as the
# JAX package holds its half paths to its full one (test_multichip.py:
# 685-688); EAM's two folds reorder the f64 density and force sums, so
# its traces agree to amplified summation noise (:729-734)
JAX_CASES = {
    "lj-gn1-222": ("lj", 8, 8, (4, 4, 4), True, 10, (1e-12,) * 3),
    "lj-gn0-122": ("lj", 8, 4, (4, 4, 4), False, 10, (1e-12,) * 3),
    "eam-122": ("eam", 8, 4, None, True, 5, (1e-7, 1e-7, 1e-6)),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_sharded_half_matches_jax(case):
    """10 LJ steps (5 EAM) with a migration every 5, a row at every step,
    from the same arrays: the port's rows against the JAX package's, the
    halo folded on the decomposed axes and wrapped on the others (the 4
    domains' mesh leaves x whole), every atom kept."""
    deck, s, ndom, nbins, gn, steps, rtol = JAX_CASES[case]
    ts = _half(_deck(deck, s), ndom, nbins, gn)
    assert ts.half_neigh and ts.ghost_newton == gn
    assert ts.mesh.shape == ({"z": 2, "y": 2, "x": 2} if ndom == 8 else
                             {"z": 2, "y": 2, "x": 1})
    want, ovf = _jax_run(ts, steps, gn)
    got = ts.run(steps)
    assert int(ovf.sum()) == 0
    for col in range(3):
        np.testing.assert_allclose(got[:, col], want[:, col],
                                   rtol=rtol[col], atol=0)
    assert int(ts.state.valid.sum()) == ts.natoms


@pytest.mark.parametrize("deck,gn", [("lj", True), ("lj", False),
                                     ("eam", True)],
                         ids=["lj-gn1", "lj-gn0", "eam"])
def test_one_cell_spans_match_one_device(deck, gn):
    """A (4,1,1) mesh of one-cell spans along x (where the JAX package
    repeats its sentinels across domains: ROADMAP section 3), port to
    port: the sharded half path against the one-device half path on the
    same grid, 4 steps with two migrations. Step 0 comes from the
    full-stencil force in the decomposed run (as in the JAX package) and
    from the half force on one device: for EAM the two differ by the
    plain grid's against the exact splines' rounding."""
    inp = _deck(deck, 6 if deck == "lj" else 5, every=2)
    inp.nx = 16
    ts = _half(inp, 4, (4, 3, 3), gn)
    assert ts.mesh.shape == {"z": 1, "y": 1, "x": 4}
    assert ts.nb_local == (1, 3, 3) and halo_extent(ts.geom) == 1
    one = Simulation.from_input(inp, dtype=F64, device="cpu",
                                nbins=ts.geom.nb, half_neigh=True,
                                ghost_newton=gn)
    a = np.array(ts.thermo_trace(ts.run(4)))
    b = np.array(one.thermo_trace(one.run(4)))
    assert a[:, 0].tolist() == b[:, 0].tolist() == list(range(5))
    np.testing.assert_allclose(a[0, 1:], b[0, 1:],
                               rtol=1e-12 if deck == "lj" else 1e-6)
    np.testing.assert_allclose(a[1:, 1:], b[1:, 1:], rtol=1e-11, atol=0)
    assert int(ts.state.valid.sum()) == ts.natoms == one.natoms


@pytest.mark.parametrize("grid", [(2, 2, 2), (1, 2, 2), (4, 1, 1)])
def test_fold_is_the_adjoint_of_the_halo(grid):
    """<fold(p), u> == <p, fill(u)> for every per-slot field u and padded
    field p, vector (the positions' halo, its image shifts taken out) and
    scalar (the fp halo): the Newton fold returns each image's
    accumulation to the slot it copies, in whichever domain owns it; the
    one-device PeriodicHalo likewise."""
    inp = _deck("lj", 8)
    prd, x, _, _, _ = create.setup_system(inp, 1, None)
    geom = cells.build_geometry(prd, inp.neigh_cut, x, nbins=(4, 4, 4))
    m = mesh.make_mesh(["cpu"] * int(np.prod(grid)), prd, grid)
    r = mesh.Router(m)
    nb_local = step.local_grid_shape(geom, m)
    hl = step.Halo(geom, m, r, 1, nb_local, F64)
    rng = np.random.default_rng(5)
    Ml, D = hl.nlocal, m.size

    def check(u, p, fill):
        lhs = float((hl.fold([p])[0] * u).sum())
        rhs = float((p * fill).sum())
        assert abs(lhs - rhs) <= 1e-12 * abs(rhs)

    u = torch.from_numpy(rng.normal(size=(D, 3, Ml)))
    shift = hl.positions([torch.zeros_like(u)])[0]
    check(u, torch.from_numpy(rng.normal(size=(D, 3, hl.nslots))),
          hl.positions([u])[0] - shift)
    u = torch.from_numpy(rng.normal(size=(D, Ml)))
    check(u, torch.from_numpy(rng.normal(size=(D, hl.nslots))),
          hl.scalars([u])[0])
    ph = PeriodicHalo(geom, 1, "cpu")
    u = torch.from_numpy(rng.normal(size=(1, geom.nslots)))
    p = torch.from_numpy(rng.normal(size=(1, int(np.prod(ph.shape)))))
    lhs = float((ph.fold([p])[0] * u).sum())
    rhs = float((p * ph.scalars([u])[0]).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


@pytest.mark.parametrize("nb", [(8, 8, 8), (12, 12, 12)])
def test_two_groups_ship_boundary_slabs_only(nb):
    """The halo of a (2,2,2) mesh whose two groups hold the x parities,
    h = 1, L cells a domain side: each group receives per field exactly
    the two boundary layers of the other group's 4 domains, 8 L^2 C
    distinct slots (where the whole of them is 4 L^3 C), and ships back
    per fold one value for each of its padded slots that is an image of
    the other group's, 8 (L+2)^2 C, both read from the routes' index
    tensors. Positions, scalars and both folds equal the one-group
    halo's bit for bit."""
    inp = _deck("lj", 8)
    prd, x, _, _, _ = create.setup_system(inp, 1, None)
    geom = cells.build_geometry(prd, inp.neigh_cut, x, nbins=nb)
    halos = []
    for devs in (["cpu"] * 8, ["cpu:0", "cpu:1"] * 4):
        m = mesh.make_mesh(devs, prd, (2, 2, 2))
        r = mesh.Router(m)
        halos.append(step.Halo(geom, m, r, 1, step.local_grid_shape(geom, m),
                               F64))
    one, two = halos
    L, C = nb[0] // 2, geom.capacity
    assert [len(h.groups) for h in halos] == [1, 2]
    assert one.sends == [[]] and one.returned(0) == 0
    for g in range(2):
        assert two.received(g) == 8 * L * L * C < 4 * L ** 3 * C
        assert [int(i.numel()) for _, i in two.sends3[g]] == \
            [3 * 8 * L * L * C]
        assert two.returned(g) == 8 * (L + 2) ** 2 * C
    r = two.router
    rng = np.random.default_rng(7)
    for shape in ((8, 3, one.nlocal), (8, one.nlocal)):
        u = torch.from_numpy(rng.normal(size=shape))
        p = torch.from_numpy(rng.normal(size=shape[:-1] + (one.nslots,)))
        fill = one.positions if len(shape) == 3 else one.scalars
        fill2 = two.positions if len(shape) == 3 else two.scalars
        for want, got in ((fill([u])[0], fill2(r.stack(list(u)))),
                          (one.fold([p])[0], two.fold(r.stack(list(p))))):
            for k, t in enumerate(r.split(got)):
                assert torch.equal(t, want[k])


def test_half_refusals():
    """A decomposed axis narrower than the halo has no Newton fold (the
    JAX package's _make_folds assertion), for LJ -gn 1 and EAM; -gn 0
    folds nothing and runs. Per-type LJ has no half path."""
    inp = _deck("lj", 3)      # 5.04 a side: 2 cells of 2.52 < 2.8, h = 2
    with pytest.raises(ValueError, match="reverse fold"):
        _half(inp, 8, (2, 2, 2), gn=True)
    ts = _half(inp, 8, (2, 2, 2), gn=False)
    assert ts.nb_local == (1, 1, 1) and halo_extent(ts.geom) == 2
    assert np.isfinite(ts.run(2)).all()
    with pytest.raises(ValueError, match="reverse fold"):
        _half(_deck("eam", 2), 8, (2, 2, 2))
    ts = ShardedSimulation.from_input(_deck("lj", 8), devices=["cpu"] * 8,
                                      dtype=F64, nbins=(4, 4, 4))
    params = LJParams(2, np.array([1.0, 1.1, 1.1, 1.2]), np.ones(4),
                      np.full(4, 6.25))
    with pytest.raises(ValueError, match="type-uniform"):
        step.make_domain_force(0, ts.geom, params, ts.mesh, ts.router,
                               ts.nb_local, F64, half_neigh=True)
