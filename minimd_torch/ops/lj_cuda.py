"""LJ cell-grid force through the hand-written CUDA kernel
(csrc/lj_force.cu), the counterpart of minimd_tpu/ops/lj_pallas.py.

The kernel reads the raw cell-major (3, M) positions; there is no
candidate pack and no halo-padded grid. It takes f32, a single-cell
stencil reach (binsize >= cutneigh), type-uniform parameters and any
capacity C <= cells.MAX_CAPACITY. On a CPU tensor the closures take the
plain version (ops/lj_grid.py); on a CUDA tensor they launch the kernel
or raise.

kept_candidates is the plain mirror of the candidates that the LJ pair
loop (csrc/lj_pair.cuh) keeps, for the tests and for chip_smoke.py's
candidate counts; no force path calls it.
"""

from __future__ import annotations

import torch

from .. import _build
from ..cells import _SENTINEL_BASE, MAX_CAPACITY, CellGeometry
from .lj import LJParams
from .lj_grid import make_lj_force_grid
from .pairgrid import halo_extent, pad_grid_int, stencil_slice, to_padded_soa

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0
# A slot holds an atom iff its x is below this (cells.is_valid).
VALID_BELOW = 0.5 * _SENTINEL_BASE
# csrc/lj_pair.cuh kKeepMargin: a candidate is kept when its squared
# distance to the own-atom box is at most cutsq * KEEP_MARGIN.
KEEP_MARGIN = 1.0 + 2.0 ** -10


def walk_candidates(geom: CellGeometry, x: torch.Tensor):
    """(cand, raw): cand (3, ncells, 27*C) the stencil's positions of every
    cell in the LJ kernels' walk order (neighbor cells dz, dy, dx from -1
    to 1, then slot), image shift added as the kernels add it; raw
    (ncells, 27*C) the same slots' stored x, which says which hold atoms.
    Needs stencil reach 1."""
    if halo_extent(geom) != 1 or len(geom.stencil) != 27:
        raise ValueError("the LJ kernels' walk needs the 27-cell stencil")
    n, C = geom.ncells, geom.capacity
    Xp = to_padded_soa(x, geom, 1)
    Rp = pad_grid_int(x[0], geom, 1)

    def walk(g):
        return torch.stack([stencil_slice(g, off, 1, geom.nb)
                            for off in geom.stencil], dim=3).reshape(n, 27 * C)

    return torch.stack([walk(g) for g in Xp]), walk(Rp)


def kept_candidates(geom: CellGeometry, x: torch.Tensor, cutsq: float,
                    valid_below: float) -> torch.Tensor:
    """(ncells, 27*C) bool in walk order: the candidates that the LJ pair
    loop stages for each cell. A candidate is kept iff its stored x is
    below valid_below and its squared distance to the bounding box of the
    cell's valid own atoms (positions as stored), image shift added, is at
    most cutsq * KEEP_MARGIN, rounded in x's dtype as the kernel rounds
    in f32 (per axis max(lo - q, q - hi, 0), then (g0^2 + g1^2) + g2^2).
    A cell without atoms keeps none."""
    n, C = geom.ncells, geom.capacity
    cand, raw = walk_candidates(geom, x)
    own = x.reshape(3, n, C)
    valid = (own[0] < valid_below)[None]
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    lo = torch.where(valid, own, inf).amin(dim=2, keepdim=True)
    hi = torch.where(valid, own, -inf).amax(dim=2, keepdim=True)
    gap = torch.clamp_min(torch.maximum(lo - cand, cand - hi), 0.0)
    dsq = gap[0] * gap[0] + gap[1] * gap[1] + gap[2] * gap[2]
    cut = torch.tensor(cutsq, dtype=x.dtype) * KEEP_MARGIN
    return (raw < valid_below) & (dsq <= cut.to(x.device))


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
    if geom.capacity > MAX_CAPACITY:
        raise ValueError(f"capacity {geom.capacity} > {MAX_CAPACITY}")


def make_lj_force_cuda(geom: CellGeometry, params: LJParams,
                       dtype=torch.float32, device="cuda"):
    """Closures (force_ev, force_noev): (x, typ) -> (f (3, M), eng, virial),
    the contract of ops/lj_grid.make_lj_force_grid. force_noev returns
    eng = virial = 0. Raises ValueError for what the kernel does not take."""
    check_lj_kernel_inputs(geom, params, dtype)

    nbx, nby, nbz = geom.nb
    C, M, ncells = geom.capacity, geom.nslots, geom.ncells
    prd = [float(p) for p in geom.prd]
    cutsq, eps, sig6 = (float(params.cutforcesq[0]), float(params.epsilon[0]),
                        float(params.sigma6[0]))
    plain_ev, plain_noev = make_lj_force_grid(geom, params, dtype, "cpu")
    zero = torch.zeros((), dtype=dtype, device=device)

    def launch(x, evflag: bool):
        global LAUNCHES
        if x.dtype != torch.float32 or tuple(x.shape) != (3, M):
            raise ValueError(f"x must be float32 (3, {M}), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        f = torch.empty((3, M), dtype=torch.float32, device=x.device)
        if evflag:
            eng = torch.empty(ncells, dtype=torch.float32, device=x.device)
            vir = torch.empty(ncells, dtype=torch.float32, device=x.device)
            eptr, vptr = eng.data_ptr(), vir.data_ptr()
        else:
            eptr = vptr = None
        rc = _build.lib().lj_force_launch(
            x.data_ptr(), f.data_ptr(), eptr, vptr, nbx, nby, nbz, C,
            *prd, cutsq, eps, sig6, VALID_BELOW, int(evflag),
            torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES += 1
        _build.check(rc, "lj_force_launch")
        if evflag:
            return f, torch.sum(eng), torch.sum(vir)
        return f, zero, zero

    def force_ev(x, typ):
        if x.device.type == "cpu":
            return plain_ev(x, typ)
        return launch(x, True)

    def force_noev(x, typ):
        if x.device.type == "cpu":
            return plain_noev(x, typ)
        return launch(x, False)

    return force_ev, force_noev
