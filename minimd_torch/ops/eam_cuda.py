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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..cells import _SENTINEL_BASE, MAX_CAPACITY, CellGeometry
from ..eam_file import PairPolys
from .eam import EAMTables
from .eam_grid import make_eam_pair_grid, make_eam_rho_grid, two_pass_force
from .pairgrid import halo_extent

# Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"eam_rho": 0, "eam_force": 0}

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
            0.5 * _SENTINEL_BASE, int(evflag),
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
            ctypes.addressof(params), nbody, *grid, int(evflag),
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
