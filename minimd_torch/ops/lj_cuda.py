"""LJ cell-grid force through the hand-written CUDA kernel
(csrc/lj_force.cu), the counterpart of minimd_tpu/ops/lj_pallas.py.

The kernel reads the raw cell-major (3, M) positions; there is no
candidate pack and no halo-padded grid. It takes f32, a single-cell
stencil reach (binsize >= cutneigh), type-uniform parameters and any
capacity C <= cells.MAX_CAPACITY. On a CPU tensor the closures take the
plain version (ops/lj_grid.py); on a CUDA tensor they launch the kernel
or raise.
"""

from __future__ import annotations

import torch

from .. import _build
from ..cells import MAX_CAPACITY, CellGeometry
from .lj import LJParams
from .lj_grid import make_lj_force_grid
from .pairgrid import halo_extent

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def make_lj_force_cuda(geom: CellGeometry, params: LJParams,
                       dtype=torch.float32, device="cuda"):
    """Closures (force_ev, force_noev): (x, typ) -> (f (3, M), eng, virial),
    the contract of ops/lj_grid.make_lj_force_grid. force_noev returns
    eng = virial = 0. Raises ValueError for what the kernel does not take."""
    if dtype != torch.float32:
        raise ValueError(f"LJ CUDA kernel is float32 only, got {dtype}")
    if halo_extent(geom) != 1:
        raise ValueError("LJ CUDA kernel needs binsize >= cutneigh "
                         f"(stencil reach 1), got {halo_extent(geom)}")
    if not params.uniform:
        raise ValueError("LJ CUDA kernel needs type-uniform LJ parameters")
    if geom.capacity > MAX_CAPACITY:
        raise ValueError(f"capacity {geom.capacity} > {MAX_CAPACITY}")

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
            *prd, cutsq, eps, sig6, int(evflag),
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
