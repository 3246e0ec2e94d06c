"""minimd_torch LJ force held against minimd_tpu on the CPU: the plain
version (ops/lj_grid.py, also what ops/lj_cuda.py takes for a CPU tensor)
against the JAX grid path in f64 and the JAX Pallas kernel (interpret
mode) in f32."""

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
from minimd_torch.ops.lj_cuda import make_lj_force_cuda
from minimd_torch.ops.lj_grid import make_lj_force_grid
from minimd_torch.sim import Simulation

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
    big = cells.build_geometry(geom.prd, inp.neigh_cut, np.zeros((1, 3)),
                               capacity=cells.MAX_CAPACITY + 8)
    with pytest.raises(ValueError, match="capacity"):
        make_lj_force_cuda(big, params, torch.float32, "cpu")


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
