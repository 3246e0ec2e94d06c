"""The LJ kernel's Verlet list (csrc/lj_list.cu) through its plain mirror,
pairgrid.verlet_lists, pairgrid.drifted and lj_grid.lj_list_force /
KeptList: the list against a brute-force search over slots and periodic
images, the force over it against lj_grid's bit for bit across drifts
below skin/2 and, with the drift check's repairs, over whole intervals of
the LJ deck, whose atoms move past skin/2; and the layout that Simulation
names to the force closures. The card tests hold the kernels against the
mirror and against the cell-walk kernel (csrc/lj_force.cu) bit for bit,
over the deck's intervals too, and count builds, reuses and repairs.
This file imports no JAX."""

import functools
import itertools

import numpy as np
import pytest
import torch

from minimd_torch import cells
from minimd_torch.cells import VALID_BELOW
from minimd_torch.config import builtin_deck
from minimd_torch.ops.lj_grid import (KeptList, lj_list_force,
                                      make_lj_force_grid)
from minimd_torch.ops.pairgrid import (drift_limit, drifted, listed_pairs,
                                       verlet_lists)
from minimd_torch.sim import Simulation

torch.set_num_threads(2)

CUTNEIGH = 2.8          # the LJ deck's cutforce 2.5 + skin 0.3
SKIN = 0.3
F32 = torch.float32


@functools.lru_cache(maxsize=None)
def _case(kind, nbins=None):
    """(sim, x f32) at s=6 (864 atoms) on the CPU: the lattice with each
    atom kicked by +-0.12 per coordinate in its slot, or the state 60
    steps in (rebinned), on the default grid (3, 3, 3) or `nbins`."""
    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 6
    sim = Simulation.from_input(inp, dtype=F32, device="cpu", nbins=nbins)
    x = sim.state.x
    if kind == "kicked":
        sign = np.sign(np.random.default_rng(11).normal(size=x.shape))
        x = x + torch.as_tensor(0.12 * sign, dtype=F32) * sim.state.valid
    else:
        sim.run(60)
        x = sim.state.x
    return sim, x


CASES = [pytest.param("kicked", None, id="kicked-333"),
         pytest.param("kicked", (1, 2, 3), id="kicked-123"),
         pytest.param("run", None, id="run-333"),
         pytest.param("run", (2, 1, 3), id="run-213")]


def _brute_force(geom, x, cutsq):
    """Per slot, the sorted stencil indices (kernel order: neighbor
    ((oz+1)*9 + (oy+1)*3 + ox+1) * C + slot) of every pair within the
    cutoff, found over all slot pairs and the 27 periodic images of each,
    kept where the unwrapped cell offset is within one cell."""
    C, (nbx, nby, nbz) = geom.capacity, geom.nb
    nb = np.array([nbx, nby, nbz])
    prd = torch.tensor(geom.prd, dtype=F32)
    valid = x[0] < VALID_BELOW
    slots = torch.nonzero(valid).flatten()
    cid = slots // C
    cc = torch.stack([cid % nbx, (cid // nbx) % nby, cid // (nbx * nby)])
    xs = x[:, slots]
    found = {int(s): [] for s in slots}
    for img in itertools.product((-1, 0, 1), repeat=3):
        n = torch.tensor(img)
        shifted = xs + (n * prd)[:, None]           # f32, as the kernel adds
        d = xs[:, :, None] - shifted[:, None, :]
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        off = (cc[:, None, :] + (n * torch.tensor(nb))[:, None, None]
               - cc[:, :, None])                     # (3, i, j)
        near = (rsq < cutsq) & (off.abs() <= 1).all(dim=0)
        if img == (0, 0, 0):
            near &= ~torch.eye(len(slots), dtype=torch.bool)
        for a, b in torch.nonzero(near).tolist():
            o = off[:, a, b] + 1
            k = int(o[2]) * 9 + int(o[1]) * 3 + int(o[0])
            found[int(slots[a])].append(k * C + int(slots[b]) % C)
    return {s: sorted(v) for s, v in found.items()}


@pytest.mark.parametrize("kind,nbins", CASES)
def test_verlet_lists_match_brute_force(kind, nbins):
    """Every valid slot's list holds exactly the pairs within cutneigh over
    the slots and their periodic images, in walk order; a slot without an
    atom lists none. Grids with 1 and 2 cells on an axis hold several
    images of one cell."""
    sim, x = _case(kind, nbins)
    geom = sim.geom
    if nbins is not None:
        assert geom.nb == nbins and int(np.abs(geom.stencil).max()) == 1
    entries, count = verlet_lists(geom, x, CUTNEIGH ** 2, VALID_BELOW)
    assert entries.shape == (int(count.max()), geom.nslots)
    want = _brute_force(geom, x, CUTNEIGH ** 2)
    valid = (x[0] < VALID_BELOW).tolist()
    for s in range(geom.nslots):
        got = entries[:int(count[s]), s].tolist()
        assert got == want.get(s, []) if valid[s] else got == []
        assert (entries[int(count[s]):, s] == -1).all()
    # ~78 pairs an atom within 2.8 sigma at density 0.8442
    mean = float(count.sum()) / int(sum(valid))
    assert 60 < mean < 100


@pytest.mark.parametrize("kind,nbins", CASES)
def test_listed_pairs_scatter_the_lists(kind, nbins):
    """listed_pairs marks each slot's list entries at their walk positions
    and nothing else."""
    sim, x = _case(kind, nbins)
    geom = sim.geom
    entries, count = verlet_lists(geom, x, CUTNEIGH ** 2, VALID_BELOW)
    listed = listed_pairs(geom, entries, count).reshape(geom.nslots, -1)
    assert torch.equal(listed.sum(dim=1), count)
    for s in range(0, geom.nslots, 7):
        assert torch.nonzero(listed[s]).flatten().tolist() == \
            entries[:int(count[s]), s].tolist()


def _drifts(x, valid, seed, frac):
    """x moved by random per-atom vectors of length frac * skin/2 (< 1)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=x.shape)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    step = torch.as_tensor(d * frac * 0.5 * SKIN, dtype=F32)
    return x + step * valid


@pytest.mark.parametrize("kind,nbins", CASES)
def test_list_force_equals_grid_across_the_interval(kind, nbins):
    """The f32 force over a list built at x equals lj_grid's, f, eng and
    virial bit for bit, at x and after drifts of up to 0.99 * skin/2 in
    random directions (the rebin's contract): no pair comes inside the
    cutoff that the list left out."""
    sim, x = _case(kind, nbins)
    geom, params = sim.geom, sim.params
    valid = x[0] < VALID_BELOW
    entries, count = verlet_lists(geom, x, CUTNEIGH ** 2, VALID_BELOW)
    grid_ev, grid_noev = make_lj_force_grid(geom, params, F32, "cpu")
    for seed, frac in ((0, 0.0), (1, 0.5), (2, 0.99), (3, 0.99)):
        xt = _drifts(x, valid, seed, frac)
        for evflag, grid in ((True, grid_ev), (False, grid_noev)):
            got = lj_list_force(geom, params, xt, entries, count, evflag)
            want = grid(xt, sim.state.typ)
            assert torch.equal(got[0], want[0])
            if evflag:
                assert torch.equal(got[1], want[1])
                assert torch.equal(got[2], want[2])


def test_list_force_misses_a_pair_past_the_skin():
    """The mirror is no copy of lj_grid: an atom carried from just outside
    cutneigh of another to inside the cutoff (a move past skin/2) is not
    on the list, and the forces part."""
    sim, x = _case("kicked")
    geom, params = sim.geom, sim.params
    entries, count = verlet_lists(geom, x, CUTNEIGH ** 2, VALID_BELOW)
    valid = torch.nonzero(x[0] < VALID_BELOW).flatten()
    a = int(valid[0])
    d = x[:, valid] - x[:, a:a + 1]
    r = (d * d).sum(dim=0).sqrt()
    b = int(valid[int(torch.nonzero((r > CUTNEIGH) & (r < 3.0))[0])])
    xt = x.clone()
    xt[:, b] = x[:, a] + (x[:, b] - x[:, a]) * (2.4 / float(r[valid == b][0]))
    got = lj_list_force(geom, params, xt, entries, count)[0]
    want = make_lj_force_grid(geom, params, F32, "cpu")[0](
        xt, sim.state.typ)[0]
    assert not torch.equal(got[:, a], want[:, a])


def test_drift_limit_and_the_check():
    """The drift limit is skin/2 less 2^-6 of it (at most 0 without a
    skin); drifted looks at valid slots only and at their distance from
    the build, in any direction."""
    assert drift_limit(2.8, 2.5) == pytest.approx(0.15 * (1 - 2 ** -6))
    assert drift_limit(2.5, 2.5) == 0.0 and drift_limit(2.4, 2.5) < 0.0
    sim, x = _case("kicked")
    limit = drift_limit(CUTNEIGH, 2.5)
    valid = torch.nonzero(x[0] < VALID_BELOW).flatten()
    empty = torch.nonzero(x[0] >= VALID_BELOW).flatten()
    assert not drifted(x, x, limit, VALID_BELOW)
    a = int(valid[3])
    for axis, (under, over) in enumerate(((0.99, 1.01), (-0.99, -1.01),
                                          (0.99, 1.01))):
        for frac, want in ((under, False), (over, True)):
            xt = x.clone()
            xt[axis, a] += frac * limit
            assert drifted(xt, x, limit, VALID_BELOW) is want
    xt = x.clone()
    xt[:, a] += 0.6 * limit          # |d| = 0.6 * sqrt(3) * limit
    assert drifted(xt, x, limit, VALID_BELOW)
    if len(empty):
        xt = x.clone()
        xt[1:, int(empty[0])] += 10.0
        assert not drifted(xt, x, limit, VALID_BELOW)


def test_kept_list_equals_grid_over_deck_intervals():
    """Three reneighbor intervals of the LJ deck (864 atoms, f32, a rebin
    every 20 steps): the force over a list built at each rebin and kept
    with the drift check's repairs (KeptList) equals lj_grid's, f, eng and
    virial, bit for bit on every step. The deck's atoms move past skin/2
    within an interval, so the check repairs the list, and a list that is
    never repaired misses pairs and gives other forces."""
    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 6
    sim = Simulation.from_input(inp, dtype=F32, device="cpu")
    geom, params = sim.geom, sim.params
    grid, _ = make_lj_force_grid(geom, params, F32, "cpu")
    x, v, typ = sim.state.x.clone(), sim.state.v.clone(), sim.state.typ
    f = sim.state.f
    kept = KeptList(geom, params, inp.neigh_cut, x)
    stale = (kept.entries, kept.count)
    repairs = misses = 0
    for n in range(60):
        v.add_(f, alpha=sim.dtforce)
        x.add_(v, alpha=inp.dt)
        if (n + 1) % 20 == 0:
            x, v, typ, ovf = cells.rebin_local(x, v, typ, geom)
            assert int(ovf) == 0
            repairs += kept.repairs
            kept = KeptList(geom, params, inp.neigh_cut, x)
            stale = (kept.entries, kept.count)
        want = grid(x, typ)
        got = kept.force(x)
        for a, b in zip(got, want):
            assert torch.equal(a, b), n
        misses += not torch.equal(
            lj_list_force(geom, params, x, *stale)[0], want[0])
        f = want[0]
        v.add_(f, alpha=sim.dtforce)
    assert repairs + kept.repairs >= 2
    assert misses >= 1


def test_simulation_names_the_layout_between_rebins():
    """The step loop names one layout to the force closures from one rebin
    to the next, and a new one after each rebin (neigh_every 20), across
    run() calls too: a closure that keeps a list builds it at
    construction and at each rebin, and reuses it on the other steps."""
    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 6
    names = []

    def recording(fn):
        def call(x, typ, layout=None):
            names.append(layout)
            return fn(x, typ)
        return call

    sim = Simulation.from_input(inp, dtype=F32, device="cpu")
    assert sim._layout is None          # the plain grid keeps no list
    sim._layout = 0
    sim.force_fn, sim.force_fn_noev = map(recording, (sim.force_fn,
                                                      sim.force_fn_noev))
    sim.run(45)
    sim.run(5)
    assert names == [0] * 19 + [1] * 20 + [2] * 11
    builds = 1 + sum(a != b for a, b in zip(names, names[1:]))
    assert builds == 1 + 45 // 20


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,nbins", CASES)
def test_list_kernel_matches_its_mirror_on_card(kind, nbins):
    """lj_list_build's lists and lengths equal verlet_lists' on the card
    (its f32 rsq rounds as the plain walk's, and no pair of these states
    lies within an ulp of cutneigh)."""
    _card()
    from minimd_torch.ops.lj_cuda import make_lj_force_cuda

    sim, x = _case(kind, nbins)
    geom = sim.geom
    ev, _ = make_lj_force_cuda(geom, sim.params, F32, "cuda",
                               cutneigh=CUTNEIGH)
    ev(x.cuda(), sim.state.typ.cuda(), layout=0)
    nl = ev.verlet
    assert torch.equal(nl.xref.cpu(), x)
    count = nl.count.long().cpu()
    entries, want = verlet_lists(geom, x, CUTNEIGH ** 2, VALID_BELOW)
    assert torch.equal(count, want)
    K = entries.shape[0]
    got = nl.entries[:K].cpu().long() & 0xFFFF
    live = torch.arange(K)[:, None] < want[None, :]
    assert torch.equal(torch.where(live, got, -1), entries)
    assert int(nl.longest) == K


@pytest.mark.cuda
def test_list_force_bitwise_equals_cell_walk_over_an_interval():
    """From a perturbed 32k lattice (+-0.03 a coordinate, the deck's
    velocities at a quarter, so that no atom moves skin/2 in 20 steps),
    20 velocity-Verlet steps with the list built once and reused: f, eng
    and virial of every step equal the cell-walk kernel's on the same
    positions bit for bit."""
    _card()
    from minimd_torch.ops import lj_cuda

    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 20
    sim = Simulation.from_input(inp, device="cuda")
    geom, params = sim.geom, sim.params
    valid = sim.state.valid
    sign = np.sign(np.random.default_rng(5).normal(size=sim.state.x.shape))
    x = sim.state.x + torch.as_tensor(0.03 * sign, dtype=F32,
                                      device="cuda") * valid
    x0, v = x.clone(), sim.state.v * 0.25
    ev, noev = lj_cuda.make_lj_force_cuda(geom, params, F32, "cuda",
                                          cutneigh=inp.neigh_cut)
    typ = sim.state.typ
    lj_cuda.LIST_BUILDS = lj_cuda.LIST_REUSES = 0
    f = ev(x, typ, layout="interval")[0]
    for step in range(20):
        v.add_(f, alpha=sim.dtforce)
        x.add_(v, alpha=inp.dt)
        for evflag, fn in ((True, ev), (False, noev)):
            got = fn(x, typ, layout="interval")
            want = lj_cuda.cell_walk(geom, params, x, evflag)
            for a, b in zip(got, want):
                assert torch.equal(a, b), step
        f = got[0]
        v.add_(f, alpha=sim.dtforce)
    moved = torch.where(valid, (x - x0).norm(dim=0), 0.0).max()
    assert 0.0 < float(moved) < 0.5 * (inp.neigh_cut - inp.force_cut)
    assert (lj_cuda.LIST_BUILDS, lj_cuda.LIST_REUSES) == (1, 40)
    assert int(ev.verlet.rebuilds) == 0


@pytest.mark.cuda
def test_list_force_bitwise_equals_cell_walk_over_deck_intervals():
    """Three intervals of the LJ deck at 32k atoms and its own velocities,
    a rebin every 20 steps through the Simulation's rebin: every step's
    f, eng and virial through the closures (a new layout named after each
    rebin) equal the cell-walk kernel's bit for bit, though the deck's
    atoms move past skin/2: the card's check repairs the list."""
    _card()
    from minimd_torch.ops import lj_cuda

    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 20
    sim = Simulation.from_input(inp, device="cuda")
    geom, params = sim.geom, sim.params
    ev, noev = sim.force_fn, sim.force_fn_noev
    x, v, typ = sim.state.x.clone(), sim.state.v.clone(), sim.state.typ
    f = sim.state.f
    layout = "first"
    for n in range(60):
        v.add_(f, alpha=sim.dtforce)
        x.add_(v, alpha=inp.dt)
        if (n + 1) % 20 == 0:
            x, v, typ, ovf = sim.rebin_fn(x, v, typ)
            assert int(ovf) == 0
            layout = n
        evflag = n % 5 == 4
        got = (ev if evflag else noev)(x, typ, layout=layout)
        want = lj_cuda.cell_walk(geom, params, x, evflag)
        for a, b in zip(got, want):
            assert torch.equal(a, b), n
        f = got[0]
        v.add_(f, alpha=sim.dtforce)
    assert int(ev.verlet.rebuilds) >= 3


@pytest.mark.cuda
def test_unnamed_layout_takes_the_cell_walk():
    """A call that names no layout gets the cell-walk kernel and keeps no
    list; so does the fused step's Simulation, whose force calls name
    none."""
    _card()
    from minimd_torch.ops import lj_cuda

    sim, x = _case("kicked")
    x = x.cuda()
    typ = sim.state.typ.cuda()
    lj_cuda.LIST_BUILDS = lj_cuda.LIST_REUSES = 0
    ev, noev = lj_cuda.make_lj_force_cuda(sim.geom, sim.params, F32, "cuda",
                                          cutneigh=CUTNEIGH)
    for evflag, fn in ((True, ev), (False, noev)):
        got = fn(x, typ)
        want = lj_cuda.cell_walk(sim.geom, sim.params, x, evflag)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not hasattr(ev, "verlet")
    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 16
    fused = Simulation.from_input(inp, device="cuda", fused_step=True)
    fused.run(40)
    assert fused._layout is None and not hasattr(fused.force_fn, "verlet")
    assert (lj_cuda.LIST_BUILDS, lj_cuda.LIST_REUSES) == (0, 0)


@pytest.mark.cuda
def test_run_counts_one_build_a_rebin():
    """Over run(100) at neigh_every 20: builds = constructions + rebins, the
    other force calls reuse the list (19 of 20); a second run reuses the
    list across the call. The check's repairs are counted on the card."""
    _card()
    from minimd_torch.ops import lj_cuda, rebin_cuda

    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 16
    lj_cuda.LIST_BUILDS = lj_cuda.LIST_REUSES = 0
    rebin_cuda.LAUNCHES = 0
    sim = Simulation.from_input(inp, device="cuda")
    assert (lj_cuda.LIST_BUILDS, lj_cuda.LIST_REUSES) == (1, 0)
    sim.run(100)
    assert rebin_cuda.LAUNCHES == 5
    assert (lj_cuda.LIST_BUILDS, lj_cuda.LIST_REUSES) == (1 + 5, 95)
    sim.run(100)
    assert (lj_cuda.LIST_BUILDS, lj_cuda.LIST_REUSES) == (1 + 10, 190)
    assert sim.state.overflow == 0
    # the deck's atoms move past skin/2 between rebins: repairs on the card
    assert int(sim.force_fn.verlet.rebuilds) > 0
