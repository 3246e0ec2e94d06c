"""minimd_torch cell pipeline held against minimd_tpu on the CPU: geometry,
initial placement, the plain pull rebin and the push mirror of the rebin
kernels must be exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimd_tpu import cells as jcells
from minimd_tpu import create
from minimd_tpu.config import builtin_deck
from minimd_tpu.state import init_state as jax_init_state
from minimd_torch import cells
from minimd_torch.ops.rebin_cuda import make_rebin_cuda
from minimd_torch.state import (geometry_from_reference, init_state,
                                state_from_numpy)

torch.set_num_threads(2)

GEOM_FIELDS = ("nb", "binsize", "capacity", "stencil", "offset", "cand_cell",
               "cand_shift", "prd")


def _lattice(s):
    inp = builtin_deck("lj")
    box = create.create_box(s, s, s, inp.rho)
    x, v = create.create_atoms(s, s, s, inp.rho, box)
    return inp, box, x, v


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def geometry_cells(geom):
    """The JAX geometry for the port's geometry (same fields)."""
    return jcells.CellGeometry(**{k: getattr(geom, k) for k in GEOM_FIELDS})


@pytest.mark.parametrize("s", [10, 32])   # 4,000 and 131,072 atoms
def test_build_geometry_matches_jax(s):
    inp, box, x, _ = _lattice(s)
    gj = jcells.build_geometry(box.prd, inp.neigh_cut, x)
    gt = cells.build_geometry(box.prd, inp.neigh_cut, x)
    for name in GEOM_FIELDS:
        a, b = getattr(gj, name), getattr(gt, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert gt.nb == ((5, 5, 5) if s == 10 else (17, 17, 17))
    assert gt.capacity == (48 if s == 10 else 40)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_state_bit_identical(dtype):
    """Stable-sort placement, sentinels and the unfolded storage
    coordinates are bit-identical to the JAX package at 4k."""
    inp, box, x, v = _lattice(10)
    typ = create.assign_types(len(x), 4)
    geom = cells.build_geometry(box.prd, inp.neigh_cut, x)
    sj = jax_init_state(x, v, typ, geometry_cells(geom), dtype=getattr(jnp, dtype))
    st = init_state(x, v, typ, geom, dtype=getattr(torch, dtype))
    for name in ("x", "v", "f", "typ", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(sj, name)),
                                      getattr(st, name).numpy(), err_msg=name)
    assert st.x.dtype == getattr(torch, dtype)
    assert int(sj.overflow) == st.overflow == 0


def _perturbed(nbins, seed=7, capacity=None, ntypes=1, dtype=torch.float32,
               kick=0.12):
    """tests/test_cells.py:87-96: n=8 lattice, one type (or ntypes of
    create.assign_types), +-kick per coordinate (0.12 there), laid out by
    the port's init_state (bit-identical to the JAX package's:
    test_init_state_bit_identical)."""
    inp, box, x, v = _lattice(8)
    geom = cells.build_geometry(box.prd, inp.neigh_cut, x, nbins=nbins,
                                capacity=capacity)
    typ = (create.assign_types(len(x), ntypes) if ntypes > 1
           else np.zeros(len(x), np.int32))
    st = init_state(x, v, typ, geom, dtype=dtype)
    xs = st.x.numpy()
    rng = np.random.default_rng(seed)
    xd = xs + (kick * np.sign(rng.normal(size=xs.shape))).astype(xs.dtype)
    return geom, xd, st.v.numpy(), st.typ.numpy()


# the rebin's cases: name -> (nbins, capacity, C, ntypes, dtype, kick,
# teleport); the first two keep their first ids
REBIN_CASES = {
    "None-48": (None, None, 48, 1, torch.float32, 0.12, False),
    "nbins1-24": ((6, 6, 6), None, 24, 1, torch.float32, 0.12, False),
    # every neighbor of every cell wraps
    "nb3": ((3, 3, 3), None, 112, 1, torch.float32, 0.12, False),
    "types4": (None, None, 48, 4, torch.float32, 0.12, False),
    "float64": (None, None, 48, 1, torch.float64, 0.12, False),
    # 32 atoms a cell laid out at C = 32: kicked cells take more than C
    "overflow": (None, 32, 32, 1, torch.float32, 0.5, False),
    # one atom moved by half the box: lost, counted, not placed
    "teleporter": (None, None, 48, 4, torch.float32, 0.12, True),
}
OVERFLOWING = ("overflow", "teleporter")
_JAX_REBIN = {}


def _rebin_case(name):
    """(geom, x, v, typ) numpy inputs of a REBIN_CASES case."""
    nbins, cap, C, ntypes, dtype, kick, teleport = REBIN_CASES[name]
    geom, xd, v, typ = _perturbed(nbins, capacity=cap, ntypes=ntypes,
                                  dtype=dtype, kick=kick)
    assert geom.capacity == C
    if teleport:
        xd[0, int(np.argmax(xd[0] < cells.VALID_BELOW))] += geom.prd[0] * 0.5
    return geom, xd, v, typ


def _jax_rebin_local(geom):
    """minimd_tpu.cells.rebin_local under jax.jit, one per grid."""
    import jax

    key = (geom.nb, geom.capacity)
    if key not in _JAX_REBIN:
        gj = geometry_cells(geom)
        _JAX_REBIN[key] = jax.jit(
            lambda a, b, c: jcells.rebin_local(a, b, c, gj))
    return _JAX_REBIN[key]


@pytest.mark.parametrize("case", list(REBIN_CASES))
def test_rebin_local_bit_identical(case):
    """rebin_local against the JAX package's (where nothing overflows;
    the two differ in what an overflowing cell keeps), the push mirror of
    the rebin kernels' phases (cells.rebin_push) against rebin_local, and
    the kernel wrapper on a CPU tensor: x, v, typ and overflow bit for
    bit."""
    geom, xd, v, typ = _rebin_case(case)
    args = [_t(a) for a in (xd, v, typ)]
    xt, vt, tt, ot = want = cells.rebin_local(*args, geom)
    assert (int(ot) > 0) == (case in OVERFLOWING)
    assert tt.dtype == torch.int32 and xt.dtype == args[0].dtype
    if case not in OVERFLOWING:
        xr, vr, tr, ov = _jax_rebin_local(geom)(xd, v, typ)
        assert int(ov) == 0
        np.testing.assert_array_equal(np.asarray(xr), xt.numpy())
        np.testing.assert_array_equal(np.asarray(vr), vt.numpy())
        np.testing.assert_array_equal(np.asarray(tr), tt.numpy())

    got = cells.rebin_push(*args, geom)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[3].dtype == torch.int32

    # the kernel wrapper takes the plain rebin_local for a CPU tensor
    got = make_rebin_cuda(geom, "cpu")(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # and one made for the card refuses them instead of falling back
    with pytest.raises(ValueError, match="rebin made for cuda"):
        make_rebin_cuda(geom, "cuda")(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nbins", [None, (2, 2, 2)])
def test_rebin_constants_match_per_call_form(nbins, dtype):
    """The rebin glue on constants built once per geometry
    (cells.RebinConstants, what Simulation and make_rebin_cuda hold) is
    bit for bit the per-call form, which builds them from the host each
    call; a second call on the same constants too, and constants of
    another dtype are refused."""
    geom, xd, v, typ = _perturbed(nbins)
    x, vt, tt = _t(xd).to(dtype), _t(v).to(dtype), _t(typ)
    rebin = cells.rebin_local if nbins is None else cells.rebin_lean
    consts = cells.RebinConstants.build(geom, dtype, "cpu")
    want = rebin(x, vt, tt, geom)
    for _ in range(2):
        got = rebin(x, vt, tt, geom, consts=consts)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    cid, xs = cells.coord_to_cell(cells.pbc_wrap(x, consts.prd), geom,
                                  consts)
    cid0, xs0 = cells.coord_to_cell(cells.pbc_wrap(x, geom.prd), geom)
    assert torch.equal(cid, cid0) and torch.equal(xs, xs0)
    other = torch.float64 if dtype == torch.float32 else torch.float32
    with pytest.raises(ValueError, match="rebin constants"):
        rebin(x, vt, tt, geom,
              consts=cells.RebinConstants.build(geom, other, "cpu"))


def test_rebin_lean_keeps_atoms_on_small_grid():
    """nb < 3 takes the sort-based rebin: the same atoms, in cell order."""
    geom, xd, v, typ = _perturbed((2, 2, 2))
    xt, vt, tt, ot = cells.rebin_lean(_t(xd), _t(v), _t(typ), geom)
    assert int(ot) == 0
    valid = cells.is_valid(xt)
    assert int(valid.sum()) == int((xd[0] < 5e5).sum())
    moved = np.sort(np.asarray(cells.pbc_wrap(_t(xd), geom.prd))[0][xd[0] < 5e5])
    got = np.sort(np.mod(xt[0][valid].numpy(), geom.prd[0]))
    np.testing.assert_allclose(got, moved, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        make_rebin_cuda(geom, "cpu")


def test_rebin_local_detects_teleporters():
    """tests/test_cells.py:51-58: an atom moved by half the box is counted,
    and neither rebin_local nor the push mirror of the kernels places it."""
    inp, box, x, v = _lattice(10)
    geom = cells.build_geometry(box.prd, inp.neigh_cut, x)
    st = init_state(x, v, create.assign_types(len(x), 4), geom)
    xt = st.x.clone()
    xt[0, 0] += float(geom.prd[0]) * 0.5
    want = cells.rebin_local(xt, st.v, st.typ, geom)
    got = cells.rebin_push(xt, st.v, st.typ, geom)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(want[3]) == 1
    assert int(cells.is_valid(want[0]).sum()) == len(x) - 1


def test_state_from_numpy_round_trip():
    """A JAX MDState carried across as numpy arrays keeps every field."""
    inp, box, x, v = _lattice(6)
    typ = create.assign_types(len(x), 4)
    gj = jcells.build_geometry(box.prd, inp.neigh_cut, x)
    sj = jax_init_state(x, v, typ, gj, dtype=jnp.float32)
    geom = geometry_from_reference(gj)
    for name in GEOM_FIELDS:
        a, b = getattr(gj, name), getattr(geom, name)
        assert np.array_equal(a, b), name
    st = state_from_numpy(*(np.asarray(getattr(sj, k)) for k in
                            ("x", "v", "f", "typ", "valid", "overflow")),
                          device="cpu", dtype=torch.float32)
    for name in ("x", "v", "f", "typ", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(sj, name)),
                                      getattr(st, name).numpy(), err_msg=name)
    assert st.typ.dtype == torch.int32 and st.valid.dtype == torch.bool
    assert st.overflow == 0
    # and the port's own placement of the same atoms is the same layout
    own = init_state(x, v, typ, geom, dtype=torch.float32)
    assert torch.equal(own.x, st.x) and torch.equal(own.typ, st.typ)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(REBIN_CASES))
def test_rebin_kernel_bit_identical_on_card(case):
    """The rebin kernels against the plain rebin_local on the card, on
    test_rebin_local_bit_identical's cases (chip_smoke.py runs the same at
    full sizes); a float64 state is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    geom, xd, v, typ = _rebin_case(case)
    args = [_t(a).cuda() for a in (xd, v, typ)]
    rebin = make_rebin_cuda(geom, "cuda")
    if args[0].dtype != torch.float32:
        with pytest.raises(ValueError):
            rebin(*args)
        return
    got = rebin(*args)
    want = cells.rebin_local(*args, geom)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
