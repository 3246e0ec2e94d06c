"""minimd_torch EAM held against minimd_tpu on the CPU: the potential file
readers and pair tables, the exact-spline force (ops/eam.py), the plain
versions of the EAM kernels (ops/eam_grid.py, also what ops/eam_cuda.py
takes for a CPU tensor) and the per-atom embedding. The JAX Pallas kernel
is held here through its XLA twin eam_grid, as tests/test_eam.py does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimd_tpu import cells as jcells
from minimd_tpu import eam_file as jeam_file
from minimd_tpu.ops import eam as jeam
from minimd_tpu.ops.eam_grid import make_eam_force_grid as jax_force_grid
from minimd_torch import cells, create, eam_file
from minimd_torch.config import builtin_deck
from minimd_torch.ops import eam_cuda
from minimd_torch.ops.eam import EAMTables, make_eam_force, spline_columns
from minimd_torch.ops.eam_grid import (embedding, make_eam_force_grid,
                                       make_eam_pair_grid, make_eam_rho_grid)
from minimd_torch.state import init_state

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tables():
    return EAMTables.from_funcfl()


@pytest.fixture(scope="module")
def lattice():
    """6^3 Cu lattice with 0.08 A normal displacements
    (tests/test_eam.py:88-94): (geometry, f64 state, valid mask)."""
    inp = builtin_deck("eam")
    box = create.create_box(6, 6, 6, inp.rho)
    x, v = create.create_atoms(6, 6, 6, inp.rho, box)
    x = x + np.random.default_rng(0).normal(0, 0.08, x.shape)
    geom = cells.build_geometry(box.prd, inp.neigh_cut, x)
    st = init_state(x, v, np.zeros(len(x), np.int32), geom,
                    dtype=torch.float64)
    return geom, st, st.valid.numpy()


def _jgeom(geom):
    return jcells.CellGeometry(**{f.name: getattr(geom, f.name) for f in
                                  dataclasses.fields(jcells.CellGeometry)})


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def test_eam_file_matches_jax(tables):
    path = eam_file.default_potential_path()
    f, jf = eam_file.read_funcfl(path), jeam_file.read_funcfl(path)
    for name in ("mass", "nrho", "drho", "nr", "dr", "cut"):
        assert getattr(f, name) == getattr(jf, name), name
    for name in ("frho", "rhor", "zr"):
        assert np.array_equal(getattr(f, name), getattr(jf, name)), name
    got, want = eam_file.file2array(f), jeam_file.file2array(jf)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    nr, dr, rhor = got[2], got[3], got[5]
    assert np.array_equal(eam_file.array2spline(nr, dr, rhor),
                          jeam_file.array2spline(nr, dr, rhor))

    jt = jeam.EAMTables.from_funcfl()
    for fld in dataclasses.fields(jt):
        assert np.array_equal(getattr(tables, fld.name),
                              getattr(jt, fld.name)), fld.name
    polys, jpolys = tables.polys, jeam_file.build_pair_polys(jt, degree=None)
    assert tables.polys is polys      # fitted once per tables object
    for fld in dataclasses.fields(jpolys):
        assert getattr(polys, fld.name) == getattr(jpolys, fld.name), fld.name
    assert {n: len(c) - 1 for n, c in polys.body.items()} == dict.fromkeys(
        ("R", "G1", "G2", "P"), 20)
    assert polys.nrows == 2 and abs(polys.split - 4.93) < 1e-9
    assert [n for n, m in polys.tail_merged.items() if m is None] == ["G1"]


def test_exact_spline_f64_matches_jax(tables, lattice):
    geom, st, valid = lattice
    jt = jeam.EAMTables.from_funcfl()
    fj, ej, vj = jax.jit(jeam.make_eam_force(_jgeom(geom), jt, 1,
                                             dtype=jnp.float64))(
        jnp.asarray(st.x.numpy()), jnp.asarray(st.typ.numpy()))
    ft, et, vt = make_eam_force(geom, tables, torch.float64)(st.x, st.typ)
    fj = np.asarray(fj)
    scale = np.abs(fj[:, valid]).max()
    assert np.abs(ft.numpy() - fj).max() / scale < 1e-12
    assert _rel(et, ej) < 1e-12 and _rel(vt, vj) < 1e-12


def test_grid_f64_matches_jax(tables, lattice):
    """The plain versions of the kernels against the JAX grid path (the
    adaptive pair tables on the CPU), ev and noev."""
    geom, st, valid = lattice
    jev, _ = jax_force_grid(_jgeom(geom), jeam.EAMTables.from_funcfl(), 1,
                            dtype=jnp.float64)
    args = (jnp.asarray(st.x.numpy()), jnp.asarray(st.typ.numpy()))
    fj, ej, vj = (np.asarray(a) for a in jax.jit(jev)(*args))
    t_ev, t_noev = make_eam_force_grid(geom, tables, torch.float64)
    ft, et, vt = t_ev(st.x, st.typ)
    scale = np.abs(fj[:, valid]).max()
    assert np.abs(ft.numpy() - fj).max() / scale < 1e-12
    assert _rel(et, ej) < 1e-12 and _rel(vt, vj) < 1e-12
    # the polynomial tables sit at f32 rounding scale of the exact spline
    fe, ee, _ = make_eam_force(geom, tables, torch.float64)(st.x, st.typ)
    assert (ft - fe).abs().max().item() / scale < 2e-6
    assert _rel(et, ee) < 1e-8

    fn, en, vn = t_noev(st.x, st.typ)
    assert torch.equal(fn, ft)
    assert float(en) == 0.0 and float(vn) == 0.0


def _jax_embedding(tables, rho, dtype):
    """fp and F(rho) of minimd_tpu's spline-row gather (ops/eam.py's
    embedding idiom, force_eam.cpp:337-347)."""
    sp = jnp.asarray(tables.frho_spline, dtype=dtype)
    p = jnp.asarray(rho, dtype) * (1.0 / tables.drho) + 1.0
    m = jnp.clip(p.astype(jnp.int32), 1, tables.nrho - 1)
    p = jnp.minimum(p - m.astype(dtype), 1.0)
    return (np.asarray(jeam._eval_deriv(sp, m, p)),
            np.asarray(jeam._eval_value(sp, m, p)))


def test_embedding_matches_jax(tables):
    """f64 against the JAX spline gather, exactly; f32 against the JAX
    Pallas embedding kernel in interpret mode. rho spans the table (and a
    little past its end, where the last row extrapolates)."""
    rng = np.random.default_rng(5)
    rhomax = (tables.nrho - 1) * tables.drho
    rho = rng.uniform(0.0, 1.02 * rhomax, 1000)
    valid = rng.uniform(size=1000) < 0.9

    fp, emb = embedding(torch.as_tensor(rho),
                        spline_columns(tables.frho_spline, torch.float64,
                                       "cpu"),
                        1.0 / tables.drho, torch.as_tensor(valid))
    jfp, jF = _jax_embedding(tables, rho, jnp.float64)
    assert np.array_equal(fp.numpy(), jfp)
    assert float(emb) == pytest.approx(jF[valid].sum(), rel=1e-14)

    from minimd_tpu.ops.eam_pallas import make_embedding_pallas

    rho32 = rho.astype(np.float32)
    noev, ev = make_embedding_pallas(jeam.EAMTables.from_funcfl(), 1000,
                                     interpret=True)
    pfp, pF = (np.asarray(a) for a in ev(jnp.asarray(rho32),
                                         jnp.asarray(valid)))
    fp32, emb32 = embedding(torch.as_tensor(rho32),
                            spline_columns(tables.frho_spline, torch.float32,
                                           "cpu"),
                            1.0 / tables.drho, torch.as_tensor(valid))
    assert np.abs(fp32.numpy() - pfp).max() / np.abs(pfp).max() <= 1e-6
    assert np.array_equal(np.asarray(noev(jnp.asarray(rho32))), pfp)
    assert abs(float(emb32) - pF.sum()) / abs(pF.sum()) <= 1e-6


def test_cuda_wrappers_take_plain_on_cpu(tables, lattice):
    """The kernel wrappers on a CPU tensor return the plain versions'
    results exactly; the kernels' coefficient block is packed right."""
    geom, st, _ = lattice
    x = st.x.to(torch.float32)
    rho_k = eam_cuda.make_eam_rho_cuda(geom, tables, device="cpu")
    pair_k = eam_cuda.make_eam_pair_cuda(geom, tables, device="cpu")
    rho_p = make_eam_rho_grid(geom, tables, torch.float32)
    pair_p = make_eam_pair_grid(geom, tables, torch.float32)
    for ev in (True, False):
        a, b = rho_k(x, ev), rho_p(x, ev)
        assert all(torch.equal(u, w) for u, w in zip(a, b))
        a, b = pair_k(x, a[1], ev), pair_p(x, b[1], ev)
        assert all(torch.equal(u, w) for u, w in zip(a, b))
    k_ev, k_noev = eam_cuda.make_eam_force_cuda(geom, tables, device="cpu")
    p_ev, p_noev = make_eam_force_grid(geom, tables, torch.float32)
    for k, p in ((k_ev, p_ev), (k_noev, p_noev)):
        assert all(torch.equal(u, w) for u, w in
                   zip(k(x, st.typ), p(x, st.typ)))
    assert eam_cuda.LAUNCHES == {"eam_rho": 0, "eam_force": 0}

    polys = tables.polys
    params, nbody = eam_cuda.pair_params(polys, tables.cut)
    assert nbody == 21 and params.nrows == 2
    assert params.t0 == 1.0 - polys.m0
    assert params.cutsq == np.float32(tables.cut ** 2)
    for k, name in enumerate(("R", "G1", "G2", "P")):
        fn = params.fn[k]
        body = np.float32(polys.body[name])
        assert list(fn.body)[:25 - len(body)] == [0.0] * (25 - len(body))
        assert np.array_equal(np.float32(list(fn.body)[25 - len(body):]),
                              body)
        merged = polys.tail_merged[name]
        assert bool(fn.is_merged) == (merged is not None)
        if merged is not None:
            assert np.array_equal(np.float32(list(fn.merged)[-len(merged):]),
                                  np.float32(merged))
        for row, coeffs in enumerate(polys.tail[name]):
            assert np.array_equal(np.float32(list(fn.rows[row])),
                                  np.float32(coeffs))


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(tables, lattice):
    geom, _, _ = lattice
    with pytest.raises(ValueError, match="float32"):
        eam_cuda.make_eam_force_cuda(geom, tables, torch.float64, "cpu")
    fine = cells.build_geometry(geom.prd, 5.95, np.zeros((1, 3)),
                                nbins=(7, 7, 7), capacity=8)
    assert int(np.abs(fine.stencil).max()) == 2
    with pytest.raises(ValueError, match="stencil reach"):
        eam_cuda.make_eam_rho_cuda(fine, tables, device="cpu")
    # no capacity is refused: past C = 512 the kernels hand their stage
    # over in parts, and on a CPU tensor the wrappers run the plain grid
    pos = np.random.default_rng(0).uniform(0, 1, (300, 3)) * geom.prd
    big = cells.build_geometry(geom.prd, 5.95, pos, nbins=(1, 1, 1),
                               capacity=cells.MAX_CAPACITY + 8)
    st = init_state(pos, pos * 0, np.zeros(300, np.int32), big,
                    dtype=torch.float32)
    got = eam_cuda.make_eam_force_cuda(big, tables, device="cpu")[0]
    want = make_eam_force_grid(big, tables, device="cpu")[0]
    assert all(torch.equal(a, b) for a, b in zip(got(st.x, st.typ),
                                                 want(st.x, st.typ)))


@pytest.mark.cuda
def test_eam_kernels_match_plain_on_card(tables, lattice):
    """The CUDA kernels against their plain versions on the card
    (chip_smoke.py runs the same at full sizes, with its tolerances)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    geom, st, _ = lattice
    x = st.x.to(device="cuda", dtype=torch.float32)
    rk, fpk, ek = eam_cuda.make_eam_rho_cuda(geom, tables)(x, True)
    rp, _, ep = make_eam_rho_grid(geom, tables, device="cuda")(x, True)
    frho = spline_columns(tables.frho_spline, torch.float32, "cuda")
    assert torch.equal(fpk, embedding(rk, frho, 1.0 / tables.drho)[0])
    assert (rk - rp).abs().max().item() / rp.abs().max().item() <= 1e-5
    assert abs(ek.item() - ep.item()) / abs(ep.item()) <= 1e-5
    fk, engk, virk = eam_cuda.make_eam_force_cuda(geom, tables)[0](x, None)
    fp, engp, virp = make_eam_force_grid(geom, tables, device="cuda")[0](
        x, None)
    assert (fk - fp).abs().max().item() / fp.abs().max().item() <= 2e-5
    assert abs(engk.item() - engp.item()) / abs(engp.item()) <= 1e-5
    assert abs(virk.item() - virp.item()) / abs(virp.item()) <= 1e-4
