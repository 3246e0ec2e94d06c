"""minimd_torch's gather-table EAM form on the CPU: the table builder
against the JAX package's, the plain versions of the gather-table kernels
(ops/eam_rows.py, also what ops/eam_rows_cuda.py takes for a CPU tensor)
against the JAX package's f64 exact spline and the port's polynomial
form, and a Simulation driven through the rows closures. The JAX
gather-table Pallas kernel is held here through its plain references (the
exact spline and the numpy table builder), not in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimd_tpu import cells as jcells
from minimd_tpu import eam_file as jeam_file
from minimd_tpu.ops import eam as jeam
from minimd_torch import cells, create
from minimd_torch.config import builtin_deck
from minimd_torch.ops import eam_rows_cuda
from minimd_torch.ops.eam import EAMTables, spline_columns
from minimd_torch.ops.eam_grid import embedding, make_eam_rho_grid
from minimd_torch.ops.eam_rows import (make_eam_force_rows,
                                       make_eam_pair_rows, make_eam_rho_rows)
from minimd_torch.sim import Simulation
from minimd_torch.state import init_state

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tables():
    return EAMTables.from_funcfl()


def _lattice(rho_scale=1.0):
    """The s=6 Cu lattice of create.setup_system at rho_scale times the
    deck's density with every atom moved by a seeded +-0.08 A per
    coordinate, laid out by init_state on the port's (solid) geometry:
    (geometry, the JAX package's copy of it, f64 state). The JAX side
    takes the same arrays (the port's layout is the JAX package's, bit for
    bit: tests/test_torch_cells.py)."""
    inp = builtin_deck("eam")
    inp.nx = inp.ny = inp.nz = 6
    inp.rho *= rho_scale
    prd, x, v, typ, _ = create.setup_system(inp)
    x = x + 0.08 * np.sign(np.random.default_rng(11).normal(size=x.shape))
    geom = cells.build_geometry(prd, inp.neigh_cut, x, solid=True)
    jgeom = jcells.CellGeometry(**{f.name: getattr(geom, f.name) for f in
                                   dataclasses.fields(jcells.CellGeometry)})
    st = init_state(x, v, typ, geom, dtype=torch.float64)
    assert st.overflow == 0 and int(st.valid.sum()) == 864
    return geom, jgeom, st


@pytest.fixture(scope="module")
def lattice():
    return _lattice()


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def test_build_pair_rows_matches_jax(tables):
    rows = tables.rows
    assert tables.rows is rows        # fitted once per tables object
    want = jeam_file.build_pair_rows(jeam.EAMTables.from_funcfl())
    for fld in dataclasses.fields(want):
        a, b = getattr(rows, fld.name), getattr(want, fld.name)
        if fld.name == "coeffs":
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)
        else:
            assert a == b, fld.name
    assert (rows.lo, rows.n_body, rows.n_entries) == (1.8, 125, 127)
    assert abs(rows.split - 4.93) < 1e-9
    assert all(c.shape == (4, 127) and c.dtype == np.float32
               for c in rows.coeffs.values())


def test_rows_force_f32_matches_jax_exact_spline(tables, lattice):
    """Bounds of tests/test_eam.py:199-207: force 2e-4 of scale, eng 1e-5,
    vir 1e-4; noev forces equal the ev forces, noev eng and vir are 0."""
    geom, jgeom, st = lattice
    fe, ee, ve = (np.asarray(a) for a in jax.jit(jeam.make_eam_force(
        jgeom, jeam.EAMTables.from_funcfl(), 1, dtype=jnp.float64))(
            jnp.asarray(st.x.numpy()), jnp.asarray(st.typ.numpy())))
    x32 = st.x.to(torch.float32)
    r_ev, r_noev = make_eam_force_rows(geom, tables)
    fr, er, vr = r_ev(x32, st.typ)
    valid = st.valid.numpy()
    scale = np.abs(fe[:, valid]).max()
    assert np.abs(fr.numpy()[:, valid] - fe[:, valid]).max() / scale < 2e-4
    assert _rel(er, ee) < 1e-5 and _rel(vr, ve) < 1e-4
    fn, en, vn = r_noev(x32, st.typ)
    assert torch.equal(fn, fr)
    assert float(en) == 0.0 and float(vn) == 0.0


def test_rows_density_matches_polynomial_form(tables, lattice):
    """rho within 1e-5 relative of the polynomial plain density; fp is the
    plain embedding of the rows density, exactly."""
    geom, _, st = lattice
    x32 = st.x.to(torch.float32)
    rho, fp, emb = make_eam_rho_rows(geom, tables)(x32, True)
    rho_p, _, emb_p = make_eam_rho_grid(geom, tables)(x32, True)
    valid = st.valid
    assert ((rho - rho_p).abs().max() / rho_p[valid].abs().max()).item() \
        < 1e-5
    frho = spline_columns(tables.frho_spline, torch.float32, "cpu")
    fp_own, emb_own = embedding(rho, frho, 1.0 / tables.drho, valid)
    assert torch.equal(fp, fp_own) and torch.equal(emb, emb_own)
    assert _rel(emb, emb_p) < 1e-5


def test_simulation_through_rows_closures(tables):
    """A 20-step f32 Simulation on the CPU whose force closures are the
    rows closures: its step-0 row against the port's f64 exact-spline row
    (T 1e-4, U 1e-6, P 2e-5 relative), and no atom lost."""
    inp = builtin_deck("eam")
    inp.nx = inp.ny = inp.nz = 6
    ref = Simulation.from_input(inp, dtype=torch.float64, device="cpu")
    sim = Simulation.from_input(inp, device="cpu")
    sim.force_fn, sim.force_fn_noev = make_eam_force_rows(sim.geom, tables)
    sim._compute_initial_force()
    _, t, u, p = sim._row0
    _, t0, u0, p0 = ref._row0
    assert abs(t - t0) < 1e-4
    assert _rel(u, u0) < 1e-6 and _rel(p, p0) < 2e-5
    trace = sim.run(20)
    assert sim._regrows == 0 and sim.state.overflow == 0
    assert int(sim.state.valid.sum()) == sim.natoms == 864
    assert np.all(np.isfinite(trace)) and trace[-1, 0] > 0.0


def test_rows_cuda_wrappers_take_plain_on_cpu(tables, lattice):
    """The kernel wrappers on a CPU tensor return the plain versions'
    results exactly and launch nothing; the kernels' table and index map
    are packed right."""
    geom, _, st = lattice
    x = st.x.to(torch.float32)
    k_ev, k_noev = eam_rows_cuda.make_eam_force_rows_cuda(geom, tables,
                                                          device="cpu")
    p_ev, p_noev = make_eam_force_rows(geom, tables)
    for k, p in ((k_ev, p_ev), (k_noev, p_noev)):
        assert all(torch.equal(u, w) for u, w in
                   zip(k(x, st.typ), p(x, st.typ)))
    assert eam_rows_cuda.LAUNCHES == {"eam_rho_rows": 0, "eam_force_rows": 0}
    rows = tables.rows
    tab = eam_rows_cuda.row_table(rows)
    assert tab.shape == (4, 127, 4)
    for q, name in enumerate(("R", "G1", "G2", "P")):
        assert np.array_equal(tab[q], rows.coeffs[name].T)
    m = eam_rows_cuda.row_map(rows, tables.cut)
    assert (m.ne, m.n_body) == (127, 125.0)
    assert m.idx_max == np.float32(126.999)
    assert m.cutsq == np.float32(tables.cut ** 2)


@pytest.mark.cuda
@pytest.mark.parametrize("rho_scale", [1.0, 2.0], ids=["lattice", "dense"])
def test_rows_kernels_match_plain_on_card(tables, rho_scale):
    """The gather-table kernels against their plain versions on the card
    (chip_smoke.py runs the same at full sizes, with its tolerances), on
    the deck's lattice and on one of twice its density, where a cell keeps
    up to 358 candidates against a stage of 9*C - 32 = 328 and an atom
    has up to 78 pairs against a list of 64: the kernels hand the stage
    and the lists over early there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    geom, _, st = _lattice(rho_scale)
    x = st.x.to(device="cuda", dtype=torch.float32)
    rk, fpk, ek = eam_rows_cuda.make_eam_rho_rows_cuda(geom, tables)(x, True)
    rp, _, ep = make_eam_rho_rows(geom, tables, device="cuda")(x, True)
    frho = spline_columns(tables.frho_spline, torch.float32, "cuda")
    assert torch.equal(fpk, embedding(rk, frho, 1.0 / tables.drho)[0])
    assert (rk - rp).abs().max().item() / rp.abs().max().item() <= 1e-5
    assert abs(ek.item() - ep.item()) / abs(ep.item()) <= 1e-5
    fk, engk, virk = eam_rows_cuda.make_eam_pair_rows_cuda(geom, tables)(
        x, fpk, True)
    fp, engp, virp = make_eam_pair_rows(geom, tables, device="cuda")(
        x, fpk, True)
    assert (fk - fp).abs().max().item() / fp.abs().max().item() <= 2e-5
    assert abs(engk.item() - engp.item()) / abs(engp.item()) <= 1e-5
    assert abs(virk.item() - virp.item()) / abs(virp.item()) <= 1e-4
