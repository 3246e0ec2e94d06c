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

pairgrid.kept_candidates is the plain mirror of the candidates that the
LJ pair loop (csrc/lj_pair.cuh, on csrc/cell_stage.cuh) keeps, for the
tests and for chip_smoke.py's candidate counts; no force path calls it.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import on_device
from ..cells import VALID_BELOW, CellGeometry
from .lj import LJParams
from .lj_grid import lj_pair_loop, make_lj_force_grid
from .pairgrid import halo_extent, plain_padded, sharded_grid

# Kernel launches since import (or since a caller reset it to 0): the
# one-device form and the sharded form (a domain of a decomposed run).
LAUNCHES = 0
SHARDED_LAUNCHES = 0


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


def make_lj_force_cuda(geom: CellGeometry, params: LJParams,
                       dtype=torch.float32, device="cuda", nb_local=None,
                       decomposed=None):
    """Closures (force_ev, force_noev): (x, typ, out=None) -> (f (3, M),
    eng, virial), the contract of ops/lj_grid.make_lj_force_grid.
    force_noev returns eng = virial = 0. Raises ValueError for what the
    kernel does not take.

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
    plain_ev, plain_noev = make_lj_force_grid(geom, params, dtype, "cpu")
    zero = torch.zeros((), dtype=dtype, device=device)

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

    def launch(x, evflag: bool, out):
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
        # a sharded launch may run on another card than the current
        with on_device(x.device, sharded):
            rc = _build.lib().lj_force_launch(
                x.data_ptr(), f.data_ptr(), eptr, vptr, nbx, nby, nbz, C,
                *prd, cutsq, eps, sig6, VALID_BELOW, int(evflag), halo, D,
                torch.cuda.current_stream(x.device).cuda_stream)
        if sharded:
            SHARDED_LAUNCHES += 1
        else:
            LAUNCHES += 1
        _build.check(rc, "lj_force_launch")
        if not evflag:
            return f, zero, zero
        if sharded:
            return (f, eng.reshape(D, ncells).sum(dim=1),
                    vir.reshape(D, ncells).sum(dim=1))
        return f, torch.sum(eng), torch.sum(vir)

    def force_ev(x, typ, out=None):
        if x.device.type == "cpu":
            return plain(x, typ, True, out)
        return launch(x, True, out)

    def force_noev(x, typ, out=None):
        if x.device.type == "cpu":
            return plain(x, typ, False, out)
        return launch(x, False, out)

    return force_ev, force_noev
