"""EAM cell-grid force through the hand-written CUDA kernels
(csrc/eam_force.cu), the counterpart of minimd_tpu/ops/eam_pallas.py's
fused kernels and make_embedding_pallas.

Two launches per force call: `eam_rho` (density, with the embedding in
its epilogue) and `eam_force` (pair forces from the fp of the 27 cells).
The kernels read the raw cell-major (3, M) positions. They take f32, a
single-cell stencil reach (binsize >= cutneigh) and any capacity
C <= cells.MAX_CAPACITY. On a CPU tensor the closures take the plain
versions (ops/eam_grid.py); on a CUDA tensor they launch the kernels or
raise.

in_cut_lists and list_steps are the plain mirror of the pair lists of
these kernels and of the gather-table ones (ops/eam_rows_cuda.py), which
share the stage and the cutoff (csrc/cell_stage.cuh: the pruned stage,
then one list of in-cut candidates per lane), for the tests and for
chip_smoke.py's candidate counts; no force path calls them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..cells import MAX_CAPACITY, VALID_BELOW, CellGeometry
from ..eam_file import PairPolys
from .eam import EAMTables
from .eam_grid import make_eam_pair_grid, make_eam_rho_grid, two_pass_force
from .pairgrid import halo_extent, kept_candidates, walk_candidates

# Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"eam_rho": 0, "eam_force": 0}
# csrc/eam_pass.cuh kStageCells (the EAM kernels' stage holds
# STAGE_CELLS * C candidates), csrc/cell_stage.cuh kListLen and kListStep
STAGE_CELLS, LIST_LEN, LIST_STEP = 9, 64, 8

# csrc/eam_force.cu's PairParams layout
_MAX_BODY, _MERGED_N, _ROW_N, _MAX_ROWS = 25, 8, 4, 4
_FN_NAMES = ("R", "G1", "G2", "P")


class _PairFn(ctypes.Structure):
    _fields_ = [("body", ctypes.c_float * _MAX_BODY),
                ("merged", ctypes.c_float * _MERGED_N),
                ("rows", (ctypes.c_float * _ROW_N) * _MAX_ROWS),
                ("is_merged", ctypes.c_int)]


class _PairParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in
                ("u_a", "u_b", "split", "cut", "rdr", "t0", "cutsq")] + [
        ("nrows", ctypes.c_int), ("fn", _PairFn * 4)]


assert ctypes.sizeof(_PairParams) == 4 * (
    8 + 4 * (_MAX_BODY + _MERGED_N + _MAX_ROWS * _ROW_N + 1))


def _right_aligned(coeffs, n: int) -> np.ndarray:
    out = np.zeros(n, np.float32)
    out[n - len(coeffs):] = coeffs
    return out


def pair_params(polys: PairPolys, cut: float) -> tuple[_PairParams, int]:
    """The kernels' PairParams for the polynomial tables (f64 fit rounded
    to f32) and the body length they are unrolled for (21 or 25)."""
    if polys.nrows > _MAX_ROWS:
        raise ValueError(f"{polys.nrows} tail rows > {_MAX_ROWS}")
    longest = max(len(polys.body[n]) for n in _FN_NAMES)
    nbody = 21 if longest <= 21 else _MAX_BODY
    if longest > _MAX_BODY:
        raise ValueError(f"body of {longest} coefficients > {_MAX_BODY}")
    p = _PairParams(u_a=polys.u_a, u_b=polys.u_b, split=polys.split,
                    cut=polys.cut, rdr=polys.rdr, t0=1.0 - polys.m0,
                    cutsq=cut * cut, nrows=polys.nrows)
    for k, name in enumerate(_FN_NAMES):
        fn = p.fn[k]
        fn.body[:] = _right_aligned(polys.body[name], _MAX_BODY).tolist()
        merged = polys.tail_merged[name]
        fn.is_merged = merged is not None
        if merged is not None:
            if len(merged) > _MERGED_N:
                raise ValueError(f"merged tail of {len(merged)} > {_MERGED_N}")
            fn.merged[:] = _right_aligned(merged, _MERGED_N).tolist()
        for row, coeffs in enumerate(polys.tail[name]):
            fn.rows[row][:] = _right_aligned(coeffs, _ROW_N).tolist()
    return p, nbody


def _check_geometry(geom: CellGeometry, dtype):
    if dtype != torch.float32:
        raise ValueError(f"EAM CUDA kernels are float32 only, got {dtype}")
    if halo_extent(geom) != 1:
        raise ValueError("EAM CUDA kernels need binsize >= cutneigh "
                         f"(stencil reach 1), got {halo_extent(geom)}")
    if geom.capacity > MAX_CAPACITY:
        raise ValueError(f"capacity {geom.capacity} > {MAX_CAPACITY}")


def _check_tensor(t, name: str, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be float32 {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_args(geom: CellGeometry):
    nbx, nby, nbz = geom.nb
    return (nbx, nby, nbz, geom.capacity, *(float(p) for p in geom.prd))


def make_eam_rho_cuda(geom: CellGeometry, tables: EAMTables,
                      dtype=torch.float32, device="cuda"):
    """rho_pass(x, evflag) -> (rho (M,), fp (M,), embed energy sum), the
    contract of ops/eam_grid.make_eam_rho_grid, through `eam_rho`."""
    _check_geometry(geom, dtype)
    M, ncells = geom.nslots, geom.ncells
    params, nbody = pair_params(tables.polys, tables.cut)
    frho = torch.as_tensor(np.ascontiguousarray(tables.frho_spline.T),
                           dtype=torch.float32, device=device)
    rdrho = 1.0 / tables.drho
    plain = make_eam_rho_grid(geom, tables, dtype, "cpu")
    zero = torch.zeros((), dtype=dtype, device=device)
    grid = _launch_args(geom)

    def rho_pass(x, evflag: bool):
        if x.device.type == "cpu":
            return plain(x, evflag)
        _check_tensor(x, "x", (3, M))
        if frho.device != x.device:
            raise ValueError(f"x on {x.device}, tables on {frho.device}")
        rho = torch.empty(M, dtype=torch.float32, device=x.device)
        fp = torch.empty(M, dtype=torch.float32, device=x.device)
        embed = (torch.empty(ncells, dtype=torch.float32, device=x.device)
                 if evflag else None)
        rc = _build.lib().eam_rho_launch(
            x.data_ptr(), rho.data_ptr(), fp.data_ptr(),
            embed.data_ptr() if evflag else None, frho.data_ptr(),
            tables.nrho, rdrho, ctypes.addressof(params), nbody, *grid,
            VALID_BELOW, int(evflag),
            torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES["eam_rho"] += 1
        _build.check(rc, "eam_rho_launch")
        return rho, fp, torch.sum(embed) if evflag else zero

    return rho_pass


def make_eam_pair_cuda(geom: CellGeometry, tables: EAMTables,
                       dtype=torch.float32, device="cuda"):
    """pair_pass(x, fp, evflag) -> (f (3, M), sum P, virial), the contract
    of ops/eam_grid.make_eam_pair_grid, through `eam_force`."""
    _check_geometry(geom, dtype)
    M, ncells = geom.nslots, geom.ncells
    params, nbody = pair_params(tables.polys, tables.cut)
    plain = make_eam_pair_grid(geom, tables, dtype, "cpu")
    zero = torch.zeros((), dtype=dtype, device=device)
    grid = _launch_args(geom)

    def pair_pass(x, fp, evflag: bool):
        if x.device.type == "cpu":
            return plain(x, fp, evflag)
        _check_tensor(x, "x", (3, M))
        _check_tensor(fp, "fp", (M,))
        if fp.device != x.device:
            raise ValueError("x and fp on different devices")
        f = torch.empty((3, M), dtype=torch.float32, device=x.device)
        if evflag:
            eng = torch.empty(ncells, dtype=torch.float32, device=x.device)
            vir = torch.empty(ncells, dtype=torch.float32, device=x.device)
            eptr, vptr = eng.data_ptr(), vir.data_ptr()
        else:
            eptr = vptr = None
        rc = _build.lib().eam_force_launch(
            x.data_ptr(), fp.data_ptr(), f.data_ptr(), eptr, vptr,
            ctypes.addressof(params), nbody, *grid, VALID_BELOW, int(evflag),
            torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES["eam_force"] += 1
        _build.check(rc, "eam_force_launch")
        if evflag:
            return f, torch.sum(eng), torch.sum(vir)
        return f, zero, zero

    return pair_pass


def make_eam_force_cuda(geom: CellGeometry, tables: EAMTables,
                        dtype=torch.float32, device="cuda"):
    """Closures (force_ev, force_noev): (x, typ) -> (f (3, M), eng_vdwl,
    virial), the contract of ops/eam_grid.make_eam_force_grid. Raises
    ValueError for what the kernels do not take."""
    return two_pass_force(make_eam_rho_cuda(geom, tables, dtype, device),
                          make_eam_pair_cuda(geom, tables, dtype, device))


def in_cut_lists(geom: CellGeometry, x: torch.Tensor, cutsq: float,
                 valid_below: float = VALID_BELOW,
                 chunk: int = 1024) -> torch.Tensor:
    """(ncells, C, 27*C) bool in walk order: for each cell and own slot,
    the candidates on the slot's list in the EAM kernels, i.e. the kept
    ones (pairgrid.kept_candidates) within the cutoff of a valid own atom,
    rsq < cutsq rounded in x's dtype, the slot itself left out. The walk
    positions of a list are its entries in list order. Computed `chunk`
    cells at a time."""
    n, C = geom.ncells, geom.capacity
    keep = kept_candidates(geom, x, cutsq, valid_below)
    cand, _ = walk_candidates(geom, x)
    own = x.reshape(3, n, C)
    lists = torch.zeros((n, C, 27 * C), dtype=torch.bool, device=x.device)
    slot = torch.arange(C, device=x.device)
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        d = own[:, sl, :, None] - cand[:, sl, None, :]
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        got = ((rsq < cutsq) & (own[0, sl] < valid_below)[..., None]
               & keep[sl, None, :])
        got[:, slot, 13 * C + slot] = False       # the atom itself
        lists[sl] = got
    return lists


def list_steps(geom: CellGeometry, lists: torch.Tensor, keep: torch.Tensor,
               chunk: int = 1024):
    """(steps, any_lane): per cell, the warp-steps of the EAM kernels' pair
    functions. steps runs the lists as csrc/cell_stage.cuh does: the
    stage of STAGE_CELLS * C candidates is handed over whenever its next
    32-wide step might not fit; within a handover the lanes' lists are
    run (their longest length) whenever one might pass LIST_LEN before the
    next LIST_STEP candidates, and at the end. any_lane counts, as the
    first design's kernels ran them, the candidates inside the cutoff for
    any lane of a 32-slot group. lists: in_cut_lists; keep:
    pairgrid.kept_candidates. Both (ncells,) int64."""
    n, C = geom.ncells, geom.capacity
    W, G = 27 * C, -(-C // 32)
    cap = STAGE_CELLS * C
    nbatch, nqb = -(-W // 32), -(-cap // LIST_STEP)
    dev = keep.device
    # the stage's handovers: segment of each 32-wide step, in walk order
    per = torch.zeros((n, nbatch * 32), dtype=torch.int64, device=dev)
    per[:, :W] = keep
    per = per.reshape(n, nbatch, 32).sum(dim=2)
    seg = torch.zeros((n, nbatch), dtype=torch.int64, device=dev)
    kept = torch.zeros(n, dtype=torch.int64, device=dev)
    sid = torch.zeros(n, dtype=torch.int64, device=dev)
    for b in range(nbatch):
        full = kept > cap - 32
        sid += full
        kept = torch.where(full, 0, kept)
        seg[:, b] = sid
        kept += per[:, b]
    seg = seg.repeat_interleave(32, dim=1)[:, :W]
    nseg = int(sid.max()) + 1
    # each kept candidate's stage index q within its handover
    k64 = keep.long()
    in_seg = torch.zeros((n, nseg), dtype=torch.int64, device=dev)
    in_seg.scatter_add_(1, seg, k64)
    base = torch.cumsum(in_seg, dim=1) - in_seg
    q = torch.cumsum(k64, dim=1) - 1 - base.gather(1, seg)
    block = (seg * nqb + q.clamp(min=0) // LIST_STEP)   # (n, W)

    steps = torch.zeros(n, dtype=torch.int64, device=dev)
    any_lane = torch.zeros(n, dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        m = sl.stop - sl.start
        lanes = torch.zeros((m, G * 32, W), dtype=torch.int64, device=dev)
        lanes[:, :C] = lists[sl]
        any_lane[sl] = (lanes.reshape(m, G, 32, W).amax(dim=2)
                        .sum(dim=(1, 2)))
        cnt = torch.zeros((m, G * 32, nseg * nqb), dtype=torch.int64,
                          device=dev)
        cnt.scatter_add_(2, block[sl, None, :].expand(m, G * 32, W), lanes)
        cnt = cnt.reshape(m, G, 32, nseg, nqb)
        got = torch.zeros((m, G), dtype=torch.int64, device=dev)
        for s_ in range(nseg):
            length = torch.zeros((m, G, 32), dtype=torch.int64, device=dev)
            for b in range(nqb):
                run = (length > LIST_LEN - LIST_STEP).any(dim=2)
                got += torch.where(run, length.amax(dim=2), 0)
                length = torch.where(run[..., None], 0, length)
                length += cnt[:, :, :, s_, b]
            got += length.amax(dim=2)
        steps[sl] = got.sum(dim=1)
    return steps, any_lane
