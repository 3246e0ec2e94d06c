"""LJ cell-grid force through the hand-written CUDA kernel
(csrc/lj_force.cu), the counterpart of minimd_tpu/ops/lj_pallas.py.

The kernel reads the raw cell-major (3, M) positions; there is no
candidate pack and no halo-padded grid on one device. Its sharded form
(a domain of a decomposed run, minimd_torch/parallel) reads the domain's
positions with one halo cell on each side of the decomposed axes, as the
halo exchange fills them, and wraps the other axes itself
(csrc/cellgrid.cuh). It takes f32, a single-cell stencil reach (binsize
>= cutneigh), type-uniform parameters and any capacity C (past C = 512
the pair loop takes its stage in parts). On a CPU tensor the closures
take the plain version (ops/lj_grid.py); on a CUDA tensor they launch
the kernel or raise.

On one device a caller that names the cell layout of x (`layout`) gets
the force over a Verlet list (csrc/lj_list.cu): each slot's neighbors
within cutneigh, as 16-bit stencil indices in the cell walk's order,
built when the named layout is not the one it was built on and reused
while it is. Each call checks on the card whether an atom has moved more
than the drift limit (pairgrid.drift_limit, skin/2 less a margin) since
the build, and if one has, rebuilds the list and sums the forces again in
the same call: f, eng and virial are the cell walk's bit for bit on every
call, with no host sync. A call that names no layout, the sharded form,
and a geometry whose list cannot be kept take the cell walk. The list has
27*C - 1 rows, so none can overflow, and is kept only where its stencil
indices fit 16 bits and it takes at most a quarter of the card's memory
(list_fits).

pairgrid.kept_candidates is the plain mirror of the candidates that the
LJ pair loop (csrc/lj_pair.cuh, on csrc/cell_stage.cuh) keeps, for the
tests and for chip_smoke.py's candidate counts; no force path calls it.
pairgrid.verlet_lists and lj_grid.lj_list_force mirror the list and the
force over it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from .._build import on_device
from ..cells import VALID_BELOW, CellGeometry
from .lj import LJParams
from .lj_grid import lj_pair_loop, make_lj_force_grid
from .pairgrid import drift_limit, halo_extent, plain_padded, sharded_grid

# Kernel launches since import (or since a caller reset it to 0): the
# one-device form and the sharded form (a domain of a decomposed run).
# A one-device call is one launch of the cell walk, or one call of the
# list force (its check, its gated repair and the force, after a list
# build where the named layout is new).
LAUNCHES = 0
SHARDED_LAUNCHES = 0
# Verlet-list builds on a newly named layout and reuses of a kept list by
# the one-device closures since import (or since a caller reset them to
# 0); the repairs that the card's check triggers are counted on the card
# (VerletList.rebuilds).
LIST_BUILDS = 0
LIST_REUSES = 0


@dataclasses.dataclass
class VerletList:
    """The Verlet list of a pair of one-device closures on the card
    (csrc/lj_list.cu): entry k of slot s at entries[k, s] (the uint16
    stencil index nb*C + j in int16's bits), count (M,) int32 the lengths,
    xref (3, M) float32 the positions at the last build or repair, longest
    (1,) int32 the longest list any build made, stale (1,) int32 the stamp
    of the last call whose check failed, rebuilds (1,) int32 the repairs
    that failed checks triggered; layout: what the caller named the layout
    it was built on (None: not built yet); stamp: the last call's."""

    entries: torch.Tensor
    count: torch.Tensor
    xref: torch.Tensor
    longest: torch.Tensor
    stale: torch.Tensor
    rebuilds: torch.Tensor
    layout: object = None
    stamp: int = 0

    @classmethod
    def empty(cls, C: int, M: int, device) -> "VerletList":
        def ints(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(ints(list_rows(C), M, dtype=torch.int16), ints(M),
                   ints(3, M, dtype=torch.float32), ints(1), ints(1),
                   ints(1))


def list_rows(C: int) -> int:
    """Rows of a Verlet list at capacity C: a slot's candidates, 27*C but
    itself."""
    return 27 * C - 1


def list_fits(geom: CellGeometry, device) -> bool:
    """Whether the one-device closures keep a Verlet list for geom on
    `device`: its stencil indices fit 16 bits (27*C <= 65536) and its
    list_rows x slots uint16 take at most a quarter of the card's memory,
    so that the run's other arrays and a second Simulation (a replay's,
    a check's) keep the rest. At the LJ deck's density and C = 40 that is
    ~3.6 KB an atom: on an 80 GB card the list is kept up to ~5.6M atoms
    and the cell walk runs past that."""
    C = geom.capacity
    if 27 * C > 1 << 16:
        return False
    total = torch.cuda.get_device_properties(device).total_memory
    return list_rows(C) * geom.nslots * 2 <= total // 4


def check_lj_kernel_inputs(geom: CellGeometry, params: LJParams, dtype):
    """Raise ValueError for what the LJ kernels (csrc/lj_pair.cuh) do not
    take."""
    if dtype != torch.float32:
        raise ValueError(f"LJ CUDA kernel is float32 only, got {dtype}")
    if halo_extent(geom) != 1:
        raise ValueError("LJ CUDA kernel needs binsize >= cutneigh "
                         f"(stencil reach 1), got {halo_extent(geom)}")
    if not params.uniform:
        raise ValueError("LJ CUDA kernel needs type-uniform LJ parameters")


def cell_walk(geom: CellGeometry, params: LJParams, x: torch.Tensor,
              evflag: bool = True):
    """(f (3, M), eng, virial) of the cell-walk kernel (csrc/lj_force.cu)
    on one device's float32 CUDA positions x (eng = virial = 0 without
    evflag), whether or not the closures keep a list for geom: what the
    force over the list is held to, bit for bit. Counts no launch."""
    check_lj_kernel_inputs(geom, params, x.dtype)
    M, ncells = geom.nslots, geom.ncells
    f = torch.empty((3, M), dtype=torch.float32, device=x.device)
    eng = torch.zeros(ncells, dtype=torch.float32, device=x.device)
    vir = torch.zeros(ncells, dtype=torch.float32, device=x.device)
    rc = _build.lib().lj_force_launch(
        x.data_ptr(), f.data_ptr(), eng.data_ptr(), vir.data_ptr(),
        *geom.nb, geom.capacity, *[float(p) for p in geom.prd],
        float(params.cutforcesq[0]), float(params.epsilon[0]),
        float(params.sigma6[0]), VALID_BELOW, int(evflag), 0, 1,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "lj_force_launch")
    return f, torch.sum(eng), torch.sum(vir)


def make_lj_force_cuda(geom: CellGeometry, params: LJParams,
                       dtype=torch.float32, device="cuda", nb_local=None,
                       decomposed=None, cutneigh: float | None = None):
    """Closures (force_ev, force_noev): (x, typ, out=None, layout=None) ->
    (f (3, M), eng, virial), the contract of
    ops/lj_grid.make_lj_force_grid. force_noev returns eng = virial = 0.
    Raises ValueError for what the kernel does not take.

    On one device the card's closures keep a Verlet list (VerletList, in
    force_ev.verlet once made) of the pairs within cutneigh (default: the
    bins' smallest side, which the stencil of reach 1 guarantees to be
    at least the cutoff the grid was made for) where cutneigh exceeds the
    cutoff and list_fits says yes. `layout` names x's cell layout: a call
    that names the layout of the last build reuses its list, a call that
    names another builds the list on x first, and a call that names none
    takes the cell walk. A caller names a new layout after every change
    of the slots' order; the card's drift check covers any motion in
    between.

    The sharded form (nb_local, decomposed: per axis x, y, z) takes the
    domains of a decomposed run on one device in one launch: x is their
    (D, 3, stored) positions with the decomposed axes padded by the halo
    exchange (sharded_grid), f their (D, 3, M_local) interior forces and
    eng, virial (D,) per domain (zero without evflag); out, when given,
    is written and returned as f."""
    check_lj_kernel_inputs(geom, params, dtype)

    nb, halo, M_in, M = sharded_grid(geom, nb_local, decomposed)
    nbx, nby, nbz = nb
    C = geom.capacity
    ncells = M // C
    sharded = nb_local is not None
    prd = [float(p) for p in geom.prd]
    cutsq, eps, sig6 = (float(params.cutforcesq[0]), float(params.epsilon[0]),
                        float(params.sigma6[0]))
    if cutneigh is None:
        cutneigh = float(np.min(geom.binsize))
    cutneighsq = float(cutneigh) ** 2
    drift_sq = drift_limit(cutneigh, float(np.sqrt(cutsq))) ** 2
    plain_ev, plain_noev = make_lj_force_grid(geom, params, dtype, "cpu")
    zero = torch.zeros((), dtype=dtype, device=device)
    verlet = {}    # the card's VerletList, or None where it does not fit

    def plain(x, typ, evflag, out):
        if not sharded:
            f, e, w = (plain_ev if evflag else plain_noev)(x, typ)
        else:
            f, e, w = [], [], []
            for xd in x:
                fg, ed, wd = lj_pair_loop(
                    plain_padded(geom, nb_local, decomposed, xd), None, geom,
                    params, dtype, evflag, nb_local=nb_local)
                f.append(torch.stack([t.reshape(M) for t in fg]))
                e.append(ed if evflag else torch.zeros((), dtype=dtype))
                w.append(wd if evflag else torch.zeros((), dtype=dtype))
            f, e, w = torch.stack(f), torch.stack(e), torch.stack(w)
        if out is not None:
            out.copy_(f)
            f = out
        return f, e, w

    def verlet_list(x, layout):
        """The VerletList of x's card where a layout is named, allocated
        at first use; None for the cell walk (no layout named, the
        sharded form, a list that would not help or fit)."""
        if layout is None or sharded or drift_sq <= 0.0:
            return None
        if x.device not in verlet:
            verlet[x.device] = force_ev.verlet = (
                VerletList.empty(C, M, x.device)
                if list_fits(geom, x.device) else None)
        return verlet[x.device]

    def build(nl, x, layout, stream):
        global LIST_BUILDS, LIST_REUSES
        if layout == nl.layout:
            LIST_REUSES += 1
            return
        rc = _build.lib().lj_list_build_launch(
            x.data_ptr(), nl.entries.data_ptr(), nl.count.data_ptr(),
            nl.xref.data_ptr(), nl.longest.data_ptr(), nbx, nby, nbz, C,
            *prd, cutneighsq, VALID_BELOW, stream)
        _build.check(rc, "lj_list_build_launch")
        nl.layout = layout
        LIST_BUILDS += 1

    def launch(x, evflag: bool, out, layout):
        global LAUNCHES, SHARDED_LAUNCHES
        lead = tuple(x.shape[:1]) if sharded else ()
        D = lead[0] if sharded else 1
        if (x.dtype != torch.float32 or tuple(x.shape) != lead + (3, M_in)
                or x.dim() != (3 if sharded else 2)):
            raise ValueError(f"x must be float32 {'(D, ' if sharded else '('}"
                             f"3, {M_in}), got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        if out is None:
            f = torch.empty(lead + (3, M), dtype=torch.float32,
                            device=x.device)
        elif (out.dtype != torch.float32 or tuple(out.shape) != lead + (3, M)
              or not out.is_contiguous() or out.device != x.device):
            raise ValueError(f"out must be contiguous float32 "
                             f"{lead + (3, M)} on {x.device}")
        else:
            f = out
        if evflag:
            eng = torch.empty(D * ncells, dtype=torch.float32,
                              device=x.device)
            vir = torch.empty(D * ncells, dtype=torch.float32,
                              device=x.device)
            eptr, vptr = eng.data_ptr(), vir.data_ptr()
        else:
            eptr = vptr = None
        nl = verlet_list(x, layout)
        # a sharded launch may run on another card than the current
        with on_device(x.device, sharded):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if nl is None:
                rc = _build.lib().lj_force_launch(
                    x.data_ptr(), f.data_ptr(), eptr, vptr, nbx, nby, nbz,
                    C, *prd, cutsq, eps, sig6, VALID_BELOW, int(evflag),
                    halo, D, stream)
            else:
                build(nl, x, layout, stream)
                # distinct from the last 2^30 calls' and from 0
                nl.stamp = nl.stamp % (1 << 30) + 1
                rc = _build.lib().lj_list_force_launch(
                    x.data_ptr(), nl.entries.data_ptr(),
                    nl.count.data_ptr(), nl.xref.data_ptr(),
                    nl.longest.data_ptr(), nl.stale.data_ptr(),
                    nl.rebuilds.data_ptr(), f.data_ptr(), eptr, vptr, nbx,
                    nby, nbz, C, *prd, cutsq, eps, sig6, cutneighsq,
                    drift_sq, VALID_BELOW, nl.stamp, int(evflag), stream)
        if sharded:
            SHARDED_LAUNCHES += 1
        else:
            LAUNCHES += 1
        _build.check(rc, "lj_force_launch" if nl is None
                     else "lj_list_force_launch")
        if not evflag:
            return f, zero, zero
        if sharded:
            return (f, eng.reshape(D, ncells).sum(dim=1),
                    vir.reshape(D, ncells).sum(dim=1))
        return f, torch.sum(eng), torch.sum(vir)

    def force_ev(x, typ, out=None, layout=None):
        if x.device.type == "cpu":
            return plain(x, typ, True, out)
        return launch(x, True, out, layout)

    def force_noev(x, typ, out=None, layout=None):
        if x.device.type == "cpu":
            return plain(x, typ, False, out)
        return launch(x, False, out, layout)

    return force_ev, force_noev
