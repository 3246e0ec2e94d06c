"""minimd_torch LJ force held against minimd_tpu on the CPU: the plain
version (ops/lj_grid.py, also what ops/lj_cuda.py takes for a CPU tensor)
against the JAX grid path in f64 and the JAX Pallas kernel (interpret
mode) in f32; and the plain mirror of the LJ kernels' candidate prune
(ops/pairgrid.kept_candidates) against every pair inside the cutoff."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimd_tpu import cells as jcells
from minimd_tpu.config import builtin_deck
from minimd_tpu.ops.lj import LJParams as JLJParams
from minimd_tpu.ops.lj_grid import make_lj_force_grid as jax_force_grid
from minimd_torch import cells
from minimd_torch.ops.lj import LJParams
from minimd_torch.cells import VALID_BELOW
from minimd_torch.ops.lj_cuda import make_lj_force_cuda
from minimd_torch.ops.lj_grid import make_lj_force_grid
from minimd_torch.ops.pairgrid import kept_candidates, walk_candidates
from minimd_torch.sim import Simulation
from minimd_torch.state import init_state

torch.set_num_threads(2)


def _jgeom(geom):
    return jcells.CellGeometry(**{f.name: getattr(geom, f.name) for f in
                                  jcells.dataclasses.fields(jcells.CellGeometry)})


def _jparams(p):
    return JLJParams(p.ntypes, p.epsilon, p.sigma6, p.cutforcesq)


def _state(nbins=None, steps=5):
    """s=6 (864 atoms), a few f64 steps in, as at tests/test_lj_trace.py:293."""
    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 6
    sim = Simulation.from_input(inp, dtype=torch.float64, device="cpu",
                                nbins=nbins)
    sim.run(steps)
    return inp, sim


def _jax_f64(geom, params, x, typ):
    fe, ee, ve = jax.jit(jax_force_grid(_jgeom(geom), _jparams(params),
                                        dtype=jnp.float64)[0])(
        jnp.asarray(x.numpy()), jnp.asarray(typ.numpy()))
    return np.asarray(fe), float(ee), float(ve)


def _check_f64(geom, params, x, typ, valid):
    fj, ej, vj = _jax_f64(geom, params, x, typ)
    ft, et, vt = make_lj_force_grid(geom, params, torch.float64)[0](x, typ)
    ft = ft.numpy()
    scale = np.abs(fj[:, valid]).max()
    assert np.abs(ft - fj).max() / scale < 1e-12
    assert abs(float(et) - ej) / abs(ej) < 1e-12
    assert abs(float(vt) - vj) / abs(vj) < 1e-12
    return fj, ej, vj


def test_plain_f64_matches_jax_grid():
    inp, sim = _state()
    _check_f64(sim.geom, sim.params, sim.state.x, sim.state.typ,
               sim.state.valid.numpy())


def test_f32_matches_pallas_interpret():
    """Through the kernel wrapper (plain version for a CPU tensor) in f32,
    against the Pallas kernel in interpret mode with the exact divide,
    with the bounds of tests/test_lj_trace.py:314-316."""
    from minimd_tpu.ops.lj_pallas import make_lj_force_pallas

    inp, sim = _state()
    geom, typ = sim.geom, sim.state.typ
    valid = sim.state.valid.numpy()
    params = LJParams.from_deck(1, inp.epsilon, inp.sigma, inp.force_cut)
    fe, ee, ve = _jax_f64(geom, params, sim.state.x, typ)
    scale = np.abs(fe[:, valid]).max()

    x32 = sim.state.x.to(torch.float32)
    p_ev, _ = make_lj_force_pallas(_jgeom(geom), _jparams(params),
                                   dtype=jnp.float32, interpret=True,
                                   recip="div")
    fp, ep, vp = jax.jit(p_ev)(jnp.asarray(x32.numpy()),
                               jnp.asarray(typ.numpy()))
    t_ev, t_noev = make_lj_force_cuda(geom, params, torch.float32, "cpu")
    ft, et, vt = t_ev(x32, typ)
    assert ft.dtype == torch.float32 and ft.shape == (3, geom.nslots)
    for f, e, w in ((np.asarray(fp), float(ep), float(vp)),
                    (ft.numpy(), float(et), float(vt))):
        assert np.abs(f[:, valid] - fe[:, valid]).max() / scale < 2e-5
        assert abs(e - ee) / abs(ee) < 1e-5
        assert abs(w - ve) / abs(ve) < 1e-4
    assert np.abs(ft.numpy() - np.asarray(fp))[:, valid].max() / scale < 2e-5

    # noev: the same forces, zero energy and virial
    fn, en, vn = t_noev(x32, typ)
    assert torch.equal(fn, ft)
    assert float(en) == 0.0 and float(vn) == 0.0


def test_sigma_not_one():
    inp, sim = _state()
    params = LJParams.from_deck(1, 1.3, 1.07, inp.force_cut)
    _check_f64(sim.geom, params, sim.state.x, sim.state.typ,
               sim.state.valid.numpy())


def test_per_type_tables():
    """Non-uniform tables: each of the 4 types' pairs get their own
    epsilon, sigma and cutoff."""
    inp, sim = _state()
    nt = 4
    i, j = np.divmod(np.arange(nt * nt), nt)
    eps = 1.0 + 0.1 * (i + j)
    sig = 0.95 + 0.02 * (i + j)
    cut = 2.3 + 0.05 * (i + j)
    params = LJParams(nt, eps, sig ** 6, cut * cut)
    assert not params.uniform
    assert len(np.unique(sim.state.typ.numpy()[sim.state.valid.numpy()])) == nt
    _check_f64(sim.geom, params, sim.state.x, sim.state.typ,
               sim.state.valid.numpy())
    with pytest.raises(ValueError):
        make_lj_force_cuda(sim.geom, params, torch.float32, "cpu")


def test_small_grid_aliased_images():
    """nbins=(2,2,2) at s=6: binsize 5.04 >= 2.8 keeps the stencil reach 1,
    and offsets -1 and +1 are two images of the same neighbor cell."""
    inp, sim = _state(nbins=(2, 2, 2), steps=3)
    geom = sim.geom
    assert geom.nb == (2, 2, 2) and int(np.abs(geom.stencil).max()) == 1
    params = sim.params
    valid = sim.state.valid.numpy()
    fj, ej, vj = _check_f64(geom, params, sim.state.x, sim.state.typ, valid)
    ft, et, vt = make_lj_force_cuda(geom, params, torch.float32, "cpu")[0](
        sim.state.x.to(torch.float32), sim.state.typ)
    scale = np.abs(fj[:, valid]).max()
    assert np.abs(ft.numpy() - fj)[:, valid].max() / scale < 2e-5
    assert abs(float(et) - ej) / abs(ej) < 1e-5


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    inp, sim = _state(steps=0)
    geom, params = sim.geom, sim.params
    with pytest.raises(ValueError, match="float32"):
        make_lj_force_cuda(geom, params, torch.float64, "cpu")
    fine = cells.build_geometry(geom.prd, inp.neigh_cut,
                                np.zeros((1, 3)), nbins=(6, 6, 6), capacity=8)
    assert int(np.abs(fine.stencil).max()) == 2
    with pytest.raises(ValueError, match="stencil reach"):
        make_lj_force_cuda(fine, params, torch.float32, "cpu")
    # no capacity is refused: past C = 512 the kernel hands its stage
    # over in parts, and on a CPU tensor the wrapper runs the plain grid
    pos = np.random.default_rng(0).uniform(0, 1, (300, 3)) * geom.prd
    big = cells.build_geometry(geom.prd, inp.neigh_cut, pos,
                               nbins=(1, 1, 1),
                               capacity=cells.MAX_CAPACITY + 8)
    st = init_state(pos, pos * 0, np.zeros(300, np.int32), big,
                    dtype=torch.float32)
    got = make_lj_force_cuda(big, params, torch.float32, "cpu")[0]
    want = make_lj_force_grid(big, params, torch.float32, "cpu")[0]
    assert all(torch.equal(a, b) for a, b in zip(got(st.x, st.typ),
                                                 want(st.x, st.typ)))


@functools.lru_cache(maxsize=None)
def _prune_state(kind):
    """(geom, params, x f32, typ) at 4k (s=10): the lattice with every atom
    kicked by +-0.12 per coordinate in its slot, or the f32 state after
    100 steps with no rebin; either way atoms lie outside their cells."""
    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 10
    inp.neigh_every = 1000
    sim = Simulation.from_input(inp, dtype=torch.float32, device="cpu")
    x = sim.state.x
    if kind == "kicked":
        sign = np.sign(np.random.default_rng(7).normal(size=x.shape))
        x = x + torch.as_tensor(0.12 * sign, dtype=x.dtype) * sim.state.valid
    else:
        sim.run(100)
        x = sim.state.x
    return sim.geom, sim.params, x, sim.state.typ


def _walk_blocks(geom, x, keep):
    """Per stencil block of the walk (27, in order): own (3, n, C, 1),
    candidates (3, n, 1, C), candidate raw x (n, 1, C), keep (n, 1, C),
    whether the block is the own cell."""
    n, C = geom.ncells, geom.capacity
    cand, raw = walk_candidates(geom, x)
    own = x.reshape(3, n, C, 1)
    for b in range(27):
        sl = slice(b * C, (b + 1) * C)
        yield (own, cand[:, :, None, sl], raw[:, None, sl],
               keep[:, None, sl], not geom.stencil[b].any())


def _in_cut(geom, own, cand, raw, center, cutsq):
    """(n, C, C) pairs of valid atoms with rsq < cutsq, self left out."""
    d = own - cand
    rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    pair = (rsq < cutsq) & (own[0] < VALID_BELOW) & (raw < VALID_BELOW)
    if center:
        pair &= ~torch.eye(geom.capacity, dtype=torch.bool)
    return pair, d, rsq


PRUNE_CASES = [pytest.param(kind, dt, id=f"{kind}-{name}")
               for kind in ("kicked", "100-steps")
               for name, dt in (("f32", torch.float32),
                                ("f64", torch.float64))]


@pytest.mark.parametrize("kind,dtype", PRUNE_CASES)
def test_kept_candidates_hold_every_pair_in_cut(kind, dtype):
    geom, params, x, _ = _prune_state(kind)
    x = x.to(dtype)
    cutsq = float(params.cutforcesq[0])
    keep = kept_candidates(geom, x, cutsq, VALID_BELOW)
    assert keep.shape == (geom.ncells, 27 * geom.capacity)
    n_pairs = 0
    for own, cand, raw, kb, center in _walk_blocks(geom, x, keep):
        pair, _, _ = _in_cut(geom, own, cand, raw, center,
                             torch.tensor(cutsq, dtype=dtype))
        assert not bool((pair & ~kb).any())
        n_pairs += int(pair.sum())
    assert n_pairs > 50 * 4000   # ~55 in-cut pairs per atom


@pytest.mark.parametrize("kind,dtype", PRUNE_CASES)
def test_force_over_kept_candidates_matches_plain_f64(kind, dtype):
    """The LJ force summed over the kept candidates only, block by block
    in walk order, in f64, against lj_grid's f64 force (the keep mask in
    the case's dtype)."""
    geom, params, x, typ = _prune_state(kind)
    x64 = x.to(torch.float64)
    cutsq = float(params.cutforcesq[0])
    eps, sig6 = float(params.epsilon[0]), float(params.sigma6[0])
    keep = kept_candidates(geom, x.to(dtype), cutsq, VALID_BELOW)
    f = torch.zeros((3, geom.ncells, geom.capacity), dtype=torch.float64)
    for own, cand, raw, kb, center in _walk_blocks(geom, x64, keep):
        pair, d, rsq = _in_cut(geom, own, cand, raw, center, cutsq)
        pair &= kb
        sr2 = torch.where(pair, 1.0 / rsq, 0.0)
        sr6 = sr2 * sr2 * sr2 * sig6
        fc = 48.0 * eps * sr6 * (sr6 - 0.5) * sr2
        f += (fc * d).sum(dim=-1)
    fp = make_lj_force_grid(geom, params, torch.float64)[1](x64, typ)[0]
    valid = cells.is_valid(x64)
    scale = fp[:, valid].abs().max()
    assert float((f.reshape(3, -1) - fp).abs().max() / scale) < 1e-12


@pytest.mark.parametrize("kind,dtype", PRUNE_CASES)
def test_kept_share_below_six_tenths(kind, dtype):
    """The prune leaves less than 0.6 of the 27*C slots (the Minkowski
    volume of a cell and the cutoff sphere holds ~360 atoms at 4k)."""
    geom, params, x, _ = _prune_state(kind)
    keep = kept_candidates(geom, x.to(dtype), float(params.cutforcesq[0]),
                           VALID_BELOW)
    share = float(keep.sum(dim=1).double().mean()) / (27 * geom.capacity)
    assert 0.1 < share < 0.6


@pytest.mark.parametrize("side", ["inside", "outside"])
def test_kept_candidates_at_the_box_corner(side):
    """A candidate diagonal to the own-atom box's lower corner (an atom
    that is the box's minimum on all three axes) at one f32 ulp inside or
    outside the cutoff is kept (the margin is 2^-10); one at 1.01 cutsq
    is not."""
    cutsq = 6.25                                     # 2.5^2
    f32 = np.float32
    seed = np.array([[4.0, 4.0, 4.0]])
    geom = cells.build_geometry((9.0, 9.0, 9.0), 2.8, seed, nbins=(3, 3, 3),
                                capacity=8)
    # the lower corner of cell (1, 1, 1) of the (offset) grid
    base = (np.asarray(geom.offset) + np.asarray(geom.binsize)).astype(f32)
    a = base + np.array([0.1, 0.2, 0.3], dtype=f32)
    b = base + np.array([1.9, 1.3, 2.2], dtype=f32)

    # f32 positions around the diagonal at distance 2.5 (cell (0, 0, 0)),
    # 128 x 32 ulp steps in x and z; rsq rounded in f32 as the plain
    # mirror rounds it: the nearest in-cut and out-of-cut ones
    q = a - f32(2.5 / np.sqrt(3.0))
    qx = (q[0] + np.arange(-64, 64) * np.spacing(q[0])).astype(f32)
    qz = (q[2] + np.arange(-16, 16) * np.spacing(q[2])).astype(f32)
    grid = [np.broadcast_to(c, (128, 32))
            for c in (qx[:, None], q[1], qz[None, :])]
    d = [a[k] - grid[k] for k in range(3)]
    r = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    one_in, one_out = (np.nextafter(f32(cutsq), f32(lim)) for lim in (0, 10))
    pick = {"inside": np.argwhere(r == one_in)[0],
            "outside": np.argwhere((r == f32(cutsq)) | (r == one_out))[0]}
    near = np.array([g[tuple(pick[side])] for g in grid], dtype=f32)
    far = a - f32(np.sqrt(1.01 * cutsq / 3.0))       # cell (0, 0, 0) too
    pos = np.stack([a, b, near, far]).astype(np.float64)
    st = init_state(pos, np.zeros_like(pos), np.zeros(4, np.int32), geom,
                    dtype=torch.float32)
    assert torch.equal(st.x[:, st.valid].T.sort(dim=0).values,
                       torch.as_tensor(pos, dtype=torch.float32)
                       .sort(dim=0).values)
    keep = kept_candidates(geom, st.x, cutsq, VALID_BELOW)
    cand, _ = walk_candidates(geom, st.x)
    own = 13                                         # cell (1, 1, 1)
    got = {tuple(cand[:, own, k].tolist()) for k in
           torch.nonzero(keep[own]).flatten().tolist()}
    assert tuple(near.astype(np.float64)) in got
    assert tuple(far.astype(np.float64)) not in got
    assert tuple(b.astype(np.float64)) in got         # own cell, slot kept


@pytest.mark.cuda
def test_lj_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card, ev and noev,
    with the bounds above (chip_smoke.py runs the same at full sizes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    inp, sim = _state()
    geom, params = sim.geom, sim.params
    x = sim.state.x.to(device="cuda", dtype=torch.float32)
    typ = sim.state.typ.cuda()
    k_ev, k_noev = make_lj_force_cuda(geom, params, torch.float32, "cuda")
    fk, ek, vk = k_ev(x, typ)
    fn, en, vn = k_noev(x, typ)
    fp, ep, vp = make_lj_force_grid(geom, params, torch.float32, "cuda")[0](
        x, typ)
    scale = fp.abs().max().item()
    assert (fk - fp).abs().max().item() / scale < 2e-5
    assert (fn - fp).abs().max().item() / scale < 2e-5
    assert abs(ek.item() - ep.item()) / abs(ep.item()) < 1e-5
    assert abs(vk.item() - vp.item()) / abs(vp.item()) < 1e-4
    assert en.item() == 0.0 and vn.item() == 0.0
