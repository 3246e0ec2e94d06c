"""The plain mirror of the EAM kernels' pair lists (ops/eam_cuda.py
in_cut_lists and list_steps over pairgrid.kept_candidates, the pruned
stage of csrc/cell_stage.cuh) against every pair inside the EAM cutoff,
and the density and force summed over the lists against the plain grid
(ops/eam_grid.py, the twin of the JAX package's eam_grid) in f64."""

import functools

import numpy as np
import pytest
import torch

from minimd_torch import cells
from minimd_torch.config import builtin_deck
from minimd_torch.ops import eam_cuda
from minimd_torch.ops.eam import EAMTables
from minimd_torch.ops.eam_grid import (eval_pair_fns, make_eam_pair_grid,
                                       make_eam_rho_grid)
from minimd_torch.ops.pairgrid import kept_candidates, walk_candidates
from minimd_torch.sim import Simulation

torch.set_num_threads(2)

VALID_BELOW = cells.VALID_BELOW


@functools.lru_cache(maxsize=None)
def _tables():
    return EAMTables.from_funcfl()


@functools.lru_cache(maxsize=None)
def _state(kind):
    """(geom, x f32) of the 4k Cu deck (s=10): the lattice with every atom
    kicked by +-0.12 A per coordinate in its slot (on the default grid,
    or on a (3, 3, 3) grid of ~148 atoms per cell, several 32-slot groups),
    or the state after 10 steps with no rebin; atoms lie outside their
    cells either way."""
    inp = builtin_deck("eam")
    inp.nx = inp.ny = inp.nz = 10
    inp.neigh_every = 1000
    sim = Simulation.from_input(inp, device="cpu",
                                nbins=(3, 3, 3) if kind == "coarse" else None)
    x = sim.state.x
    if kind == "steps":
        sim.run(10)
        x = sim.state.x
    else:
        sign = np.sign(np.random.default_rng(7).normal(size=x.shape))
        x = x + torch.as_tensor(0.12 * sign, dtype=x.dtype) * sim.state.valid
    return sim.geom, x


@functools.lru_cache(maxsize=None)
def _lists(kind, dtype):
    """(geom, x in dtype, keep, lists) of a case: the mirror's keep mask
    and per-slot lists."""
    geom, x = _state(kind)
    x = x.to(dtype)
    cutsq = _tables().cut ** 2
    return (geom, x, kept_candidates(geom, x, cutsq, VALID_BELOW),
            eam_cuda.in_cut_lists(geom, x, cutsq, chunk=64))


@functools.lru_cache(maxsize=None)
def _in_cut_all(kind, dtype):
    """(n, C, 27*C) pairs of valid atoms with rsq < cutsq over every
    candidate of the walk (pruned or not), the atom itself left out."""
    geom, x = _state(kind)
    x = x.to(dtype)
    cutsq = _tables().cut ** 2
    n, C = geom.ncells, geom.capacity
    cand, raw = walk_candidates(geom, x)
    own = x.reshape(3, n, C)
    d = own[:, :, :, None] - cand[:, :, None, :]
    rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    pair = ((rsq < cutsq) & (own[0] < VALID_BELOW)[..., None]
            & (raw < VALID_BELOW)[:, None, :])
    slot = torch.arange(C)
    pair[:, slot, 13 * C + slot] = False
    return pair


CASES = [pytest.param(kind, dt, id=f"{kind}-{name}")
         for kind in ("kicked", "steps")
         for name, dt in (("f32", torch.float32), ("f64", torch.float64))]
CASES.append(pytest.param("coarse", torch.float32, id="coarse-f32"))


@pytest.mark.parametrize("kind,dtype", CASES)
def test_lists_hold_exactly_the_pairs_in_cut(kind, dtype):
    """Every pair inside the cutoff is kept, and each slot's list holds
    exactly its in-cut pairs (walk positions ascending: walk order); the
    prune keeps less than 0.3 of the 27*C slots."""
    geom, x, keep, lists = _lists(kind, dtype)
    want = _in_cut_all(kind, dtype)
    assert not bool((want & ~keep[:, None, :]).any())
    assert torch.equal(lists, want)
    natoms = int(cells.is_valid(x).sum())
    assert int(lists.sum()) > 38 * natoms        # ~40 pairs per atom
    share = float(keep.sum(dim=1).double().mean()) / (27 * geom.capacity)
    assert 0.05 < share < 0.3


@pytest.mark.parametrize("kind", ["kicked", "steps", "coarse"])
def test_list_steps_run_each_list_once(kind):
    """The lanes run their lists in lockstep: per cell, one step per entry
    of each 32-slot group's longest list while no stage or list is handed
    over early (every case here), against the first design's steps on
    every candidate in the cutoff of any lane; the coarse grid spans
    several groups per cell."""
    geom, _, keep, lists = _lists(kind, torch.float32)
    steps, any_lane = eam_cuda.list_steps(geom, lists, keep, chunk=64)
    n, C = geom.ncells, geom.capacity
    groups = -(-C // 32)
    per_lane = torch.zeros((n, groups * 32), dtype=torch.int64)
    per_lane[:, :C] = lists.sum(dim=2)
    longest = per_lane.reshape(n, groups, 32).amax(dim=2).sum(dim=1)
    assert torch.equal(steps, longest)
    assert float(steps.sum()) < 0.3 * float(any_lane.sum())
    if kind == "coarse":
        assert groups >= 5 and int((per_lane > 0).sum()) > 4000 * 0.99


def test_list_steps_hand_over_a_full_stage():
    """A stage smaller than the kept candidates is handed over in parts,
    and a list that might pass its length is run early: more steps than
    the longest lists, each list entry still run once (the steps count
    entries, so a larger total means more, shorter runs)."""
    geom, _, keep, lists = _lists("kicked", torch.float32)
    base, _ = eam_cuda.list_steps(geom, lists, keep)
    saved = eam_cuda.STAGE_CELLS, eam_cuda.LIST_LEN
    try:
        eam_cuda.STAGE_CELLS, eam_cuda.LIST_LEN = 3, 16
        split, _ = eam_cuda.list_steps(geom, lists, keep)
    finally:
        eam_cuda.STAGE_CELLS, eam_cuda.LIST_LEN = saved
    assert bool((split >= base).all()) and int(split.sum()) > int(base.sum())
    assert int(split.max()) <= int(lists.sum(dim=(1, 2)).max())


def _sums_over_lists(geom, x64, lists, fp):
    """(rho (M,), f (3, M)) in f64 over the list entries, in walk order:
    rho_i = sum R(r), f_i -= ((fp_i + fp_j) G1 + G2) d."""
    n, C = geom.ncells, geom.capacity
    polys = _tables().polys
    cand, _ = walk_candidates(geom, x64)
    _, fp_walk = walk_candidates(geom, torch.stack([fp] * 3))  # no shift
    own = x64.reshape(3, n, C)
    fpi = fp.reshape(n, C, 1)
    rho = torch.zeros((n, C), dtype=torch.float64)
    f = torch.zeros((3, n, C), dtype=torch.float64)
    for c0 in range(0, n, 16):
        sl = slice(c0, c0 + 16)
        d = own[:, sl, :, None] - cand[:, sl, None, :]
        r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        g = eval_pair_fns(torch.where(lists[sl], r, 1.0), polys,
                          ("R", "G1", "G2"))
        on = lists[sl]
        rho[sl] = torch.where(on, g["R"], 0.0).sum(dim=2)
        psip = (fpi[sl] + fp_walk[sl, None, :]) * g["G1"] + g["G2"]
        f[:, sl] = -(torch.where(on, psip, 0.0) * d).sum(dim=3)
    return rho.reshape(-1), f.reshape(3, -1)


@pytest.mark.parametrize("kind,dtype", CASES[:4])
def test_sums_over_lists_match_plain_f64(kind, dtype):
    """rho and the force summed over the lists (the lists from the case's
    dtype, the sums in f64) against eam_grid's f64 passes, to 1e-12 of
    their scale."""
    geom, _, keep, _ = _lists(kind, dtype)
    x64 = _state(kind)[1].to(torch.float64)
    tables = _tables()
    lists = _in_cut_all(kind, torch.float64) & keep[:, None, :]
    rho_want, fp, _ = make_eam_rho_grid(geom, tables, torch.float64)(x64,
                                                                     False)
    f_want, _, _ = make_eam_pair_grid(geom, tables, torch.float64)(x64, fp,
                                                                   False)
    rho, f = _sums_over_lists(geom, x64, lists, fp)
    valid = cells.is_valid(x64)
    assert float((rho - rho_want).abs().max()
                 / rho_want[valid].abs().max()) < 1e-12
    assert float((f - f_want).abs().max()
                 / f_want[:, valid].abs().max()) < 1e-12
