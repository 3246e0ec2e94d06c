"""minimd_torch cell pipeline held against minimd_tpu on the CPU: geometry,
initial placement and the plain pull rebin must be exact."""

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


def _perturbed(nbins, seed=7):
    """tests/test_cells.py:87-96: n=8 lattice, one type, ±0.12 per
    coordinate."""
    inp, box, x, v = _lattice(8)
    geom = cells.build_geometry(box.prd, inp.neigh_cut, x, nbins=nbins)
    sj = jax_init_state(x, v, np.zeros(len(x), np.int32), geometry_cells(geom),
                        dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    xd = np.asarray(sj.x) + (0.12 * np.sign(rng.normal(size=sj.x.shape))
                             ).astype(np.float32)
    return geom, xd, np.asarray(sj.v), np.asarray(sj.typ)


@pytest.mark.parametrize("nbins,C", [(None, 48), ((6, 6, 6), 24)])
def test_rebin_local_bit_identical(nbins, C):
    import jax

    geom, xd, v, typ = _perturbed(nbins)
    assert geom.capacity == C
    gj = geometry_cells(geom)
    xr, vr, tr, ov = jax.jit(lambda a, b, c: jcells.rebin_local(a, b, c, gj))(
        xd, v, typ)
    xt, vt, tt, ot = cells.rebin_local(_t(xd), _t(v), _t(typ), geom)
    assert int(ov) == int(ot) == 0
    np.testing.assert_array_equal(np.asarray(xr), xt.numpy())
    np.testing.assert_array_equal(np.asarray(vr), vt.numpy())
    np.testing.assert_array_equal(np.asarray(tr), tt.numpy())
    assert tt.dtype == torch.int32

    # the kernel wrapper takes the plain pull for a CPU tensor
    xk, vk, tk, ok = make_rebin_cuda(geom, "cpu")(_t(xd), _t(v), _t(typ))
    assert int(ok) == 0
    assert torch.equal(xk, xt) and torch.equal(vk, vt) and torch.equal(tk, tt)


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
    """tests/test_cells.py:51-58: an atom moved by half the box is counted."""
    inp, box, x, v = _lattice(10)
    geom = cells.build_geometry(box.prd, inp.neigh_cut, x)
    st = init_state(x, v, create.assign_types(len(x), 4), geom)
    xt = st.x.clone()
    xt[0, 0] += float(geom.prd[0]) * 0.5
    _, _, _, ovf = cells.rebin_local(xt, st.v, st.typ, geom)
    assert int(ovf) >= 1


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


def test_rebin_kernel_bit_identical_on_card():
    """The CUDA pull against the plain pull on the card (chip_smoke.py runs
    the same at full sizes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    geom, xd, v, typ = _perturbed(None)
    args = [_t(a).cuda() for a in (xd, v, typ)]
    got = make_rebin_cuda(geom, "cuda")(*args)
    want = cells.rebin_local(*args, geom)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
