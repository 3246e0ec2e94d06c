"""minimd_torch's half-neighbor forces (ops/lj_half.py with both -gn
variants, ops/eam_half.py) held against minimd_tpu's on the CPU in
float64: the same seeded lattice through both packages, the port's half
path against its own full path, gn = 0 against gn = 1 numerically, and a
short half-path run through the reference's trace comparator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimd_tpu import cells as jcells
from minimd_tpu.ops.eam import EAMTables as JEAMTables
from minimd_tpu.ops.eam_half import make_eam_force_half as jax_eam_half
from minimd_tpu.ops.lj import LJParams as JLJParams
from minimd_tpu.ops.lj_half import make_lj_force_half as jax_lj_half
from minimd_torch import cells, create
from minimd_torch.config import builtin_deck
from minimd_torch.ops.eam import EAMTables, make_eam_force
from minimd_torch.ops.eam_half import make_eam_force_half
from minimd_torch.ops.lj import LJParams
from minimd_torch.ops import lj_half
from minimd_torch.ops.lj_grid import make_lj_force_grid
from minimd_torch.ops.lj_half import make_lj_force_half
from minimd_torch.sim import Simulation
from minimd_torch.state import init_state
from minimd_torch.validate import compare_traces

torch.set_num_threads(2)

TOL = 1e-12    # float64: the two packages differ in summation order only


def _lattice(deck, s=6, seed=3, sigma=0.03):
    """A shipped deck at size s with every atom moved by N(0, sigma) from a
    numpy seed (tests/test_lj_trace.py:140), in float64."""
    inp = builtin_deck(deck)
    inp.nx = inp.ny = inp.nz = s
    prd, x, v, typ, _ = create.setup_system(inp)
    x = x + np.random.default_rng(seed).normal(0, sigma, x.shape)
    geom = cells.build_geometry(prd, inp.neigh_cut, x, solid=deck == "eam")
    st = init_state(x, v, typ, geom, dtype=torch.float64)
    return inp, geom, st


def _jgeom(geom):
    fields = jcells.dataclasses.fields(jcells.CellGeometry)
    return jcells.CellGeometry(**{f.name: getattr(geom, f.name)
                                  for f in fields})


def _close(got, want, valid):
    """Forces to TOL of their scale, energy and virial to TOL relative."""
    (fg, eg, vg), (fw, ew, vw) = got, want
    fg, fw = np.asarray(fg)[:, valid], np.asarray(fw)[:, valid]
    assert np.abs(fg - fw).max() / np.abs(fw).max() < TOL
    assert abs(float(eg) - float(ew)) / abs(float(ew)) < TOL
    assert abs(float(vg) - float(vw)) / abs(float(vw)) < TOL


@pytest.fixture(scope="module")
def lj():
    inp, geom, st = _lattice("lj")
    params = LJParams.from_deck(1, inp.epsilon, inp.sigma, inp.force_cut)
    return inp, geom, st, params


@pytest.fixture(scope="module")
def eam():
    inp, geom, st = _lattice("eam", sigma=0.05)
    return inp, geom, st, EAMTables.from_funcfl()


@pytest.mark.parametrize("gn", [True, False], ids=["gn1", "gn0"])
def test_lj_half_matches_jax(lj, gn):
    """Both -gn variants against minimd_tpu's make_lj_force_half (jit,
    f64); noev gives the ev forces bit for bit and zero accumulators."""
    _, geom, st, params = lj
    assert geom.nb == (3, 3, 3)      # every cell touches the halo
    jparams = JLJParams(params.ntypes, params.epsilon, params.sigma6,
                        params.cutforcesq)
    want = jax.jit(jax_lj_half(_jgeom(geom), jparams, dtype=jnp.float64,
                               ghost_newton=gn)[0])(
        jnp.asarray(st.x.numpy()), jnp.asarray(st.typ.numpy()))
    ev, noev = make_lj_force_half(geom, params, torch.float64,
                                  ghost_newton=gn)
    got = ev(st.x, st.typ)
    _close(got, want, st.valid.numpy())
    fn, en, vn = noev(st.x, st.typ)
    assert torch.equal(fn, got[0])
    assert float(en) == 0.0 and float(vn) == 0.0


def test_eam_half_matches_jax(eam):
    _, geom, st, tables = eam
    want = jax.jit(jax_eam_half(_jgeom(geom), JEAMTables.from_funcfl(),
                                dtype=jnp.float64)[0])(
        jnp.asarray(st.x.numpy()), jnp.asarray(st.typ.numpy()))
    ev, noev = make_eam_force_half(geom, tables, torch.float64)
    got = ev(st.x, st.typ)
    _close(got, want, st.valid.numpy())
    fn, en, vn = noev(st.x, st.typ)
    assert torch.equal(fn, got[0])
    assert float(en) == 0.0 and float(vn) == 0.0


@pytest.mark.parametrize("case", ["lj-gn1", "lj-gn0", "eam"])
def test_half_matches_port_full(lj, eam, case):
    """Each pair once with Newton's fold (or gn = 0's duplicates) gives the
    port's full-stencil forces, energy and virial (ref force_lj.cpp:185-263
    against :420-442; force_eam.cpp:126-267 against :274-449)."""
    if case == "eam":
        _, geom, st, tables = eam
        half = make_eam_force_half(geom, tables, torch.float64)[0]
        full = make_eam_force(geom, tables, torch.float64)
    else:
        _, geom, st, params = lj
        half = make_lj_force_half(geom, params, torch.float64,
                                  ghost_newton=case == "lj-gn1")[0]
        full = make_lj_force_grid(geom, params, torch.float64)[0]
    _close(half(st.x, st.typ), full(st.x, st.typ), st.valid.numpy())


@pytest.mark.parametrize("per_batch", [1, 5], ids=["loop", "batches-of-5"])
@pytest.mark.parametrize("case", ["lj-gn1", "lj-gn0", "eam"])
def test_half_batches_match_one_batch(lj, eam, case, per_batch,
                                      monkeypatch):
    """A pair budget that splits the half stencil into batches (one offset
    each, as the JAX package loops, or five) gives the one-batch forces,
    energy and virial: the batching bounds memory and changes nothing
    else."""
    _, geom, st, arg = eam if case == "eam" else lj

    def make():
        if case == "eam":
            return make_eam_force_half(geom, arg, torch.float64)[0]
        return make_lj_force_half(geom, arg, torch.float64,
                                  ghost_newton=case == "lj-gn1")[0]

    one = make()
    monkeypatch.setattr(lj_half, "PAIR_BUDGET",
                        per_batch * geom.nslots * geom.capacity)
    assert len(lj_half.offset_chunks(lj_half.positive_half(geom), geom)) \
        == -(-13 // per_batch)
    _close(make()(st.x, st.typ), one(st.x, st.typ), st.valid.numpy())


def _half_sim(deck, gn=True, nstat=5, half=True):
    inp = builtin_deck(deck)
    inp.nx = inp.ny = inp.nz = 6
    inp.thermo_nstat = nstat
    return Simulation.from_input(inp, dtype=torch.float64, device="cpu",
                                 half_neigh=half, ghost_newton=gn)


def test_gn0_tracks_gn1():
    """-gn 0 and -gn 1 are one physics decomposed two ways: their f64
    rows agree numerically at 1e-9 relative (not as printed strings, whose
    last digit the summation order may move), step 0 included."""
    sims = {gn: _half_sim("lj", gn) for gn in (True, False)}
    rows = {gn: np.array(s.thermo_trace(s.run(20))) for gn, s in sims.items()}
    assert rows[True][:, 0].tolist() == [0, 5, 10, 15, 20]
    np.testing.assert_allclose(rows[False], rows[True], rtol=1e-9,
                               atol=1e-12)
    for s in sims.values():
        assert s.state.overflow == 0 and s.half_neigh
        assert int(s.state.valid.sum()) == s.natoms == 864


@pytest.mark.parametrize("deck", ["lj", "eam"])
def test_half_run_passes_the_trace_comparator(deck):
    """A 20-step half-path run() against the port's full path through the
    reference's statistical comparator at precision 8, and its rows within
    1e-9 of the full path's."""
    half, full = _half_sim(deck), _half_sim(deck, half=False)
    rows = half.thermo_trace(half.run(20))
    ref = full.thermo_trace(full.run(20))
    res = compare_traces(rows, ref, natoms=864, system=deck, precision=8)
    assert res.passed, str(res)
    np.testing.assert_allclose(np.array(rows), np.array(ref), rtol=1e-9)
    assert half.state.overflow == 0 and half._regrows == 0
