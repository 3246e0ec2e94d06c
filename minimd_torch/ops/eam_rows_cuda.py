"""EAM force through the hand-written gather-table CUDA kernels
(csrc/eam_rows.cu), the counterpart of minimd_tpu/ops/eam_pallas.py's
make_eam_force_pallas_rows.

Two launches per force call, as in ops/eam_cuda.py: `eam_rho_rows`
(density through the R table, with the embedding in its epilogue) and
`eam_force_rows` (pair forces through the G1, G2 and, with evflag, P
tables). Both run the passes of csrc/eam_pass.cuh that eam_cuda's
kernels run (one warp per cell on the pruned stage and per-lane in-cut
lists of csrc/cell_stage.cuh), with a cubic from the tables (read from
global memory) in place of the Horner; eam_cuda.in_cut_lists and
list_steps mirror their lists too (the same cutoff, see row_map). The tables are eam_file.PairRows with degree 3 (4
coefficients per piece). The kernels take f32, stencil reach 1 and any
capacity C; the JAX kernel's 3*C <= 128 limit is a TPU lane limit and is
not carried over. On a CPU tensor the closures take the plain versions
(ops/eam_rows.py); on a CUDA tensor they launch the kernels or raise. Simulation does not wire this form in; a caller sets a
Simulation's force_fn / force_fn_noev to make_eam_force_rows_cuda's
closures.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..cells import VALID_BELOW, CellGeometry
from ..eam_file import PairRows
from .eam import EAMTables
from .eam_cuda import _check_geometry, _check_tensor, _launch_args
from .eam_grid import two_pass_force
from .eam_rows import make_eam_pair_rows, make_eam_rho_rows

# Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"eam_rho_rows": 0, "eam_force_rows": 0}

_FN_NAMES = ("R", "G1", "G2", "P")


class _RowMap(ctypes.Structure):
    """csrc/eam_rows.cu's RowMap: the index map of eval_pair_rows."""
    _fields_ = [(name, ctypes.c_float) for name in
                ("lo", "split", "inv_h", "rdr", "n_body", "idx_max",
                 "cutsq")] + [("ne", ctypes.c_int)]


def row_map(rows: PairRows, cut: float) -> _RowMap:
    """The kernels' RowMap; its cutsq is eam_cuda.pair_params's (cut * cut
    rounded to f32), so both EAM forms list the same in-cut pairs."""
    return _RowMap(lo=rows.lo, split=rows.split, inv_h=rows.inv_h,
                   rdr=rows.rdr, n_body=float(rows.n_body),
                   idx_max=rows.n_entries - 1.0 + 0.999, cutsq=cut * cut,
                   ne=rows.n_entries)


def row_table(rows: PairRows) -> np.ndarray:
    """(4, n_entries, 4) float32: function (R, G1, G2, P), piece, then the
    piece's cubic in descending powers, one float4 per piece."""
    for name in _FN_NAMES:
        if rows.coeffs[name].shape[0] != 4:
            raise ValueError(f"the gather-table kernels take cubics; {name} "
                             f"has degree {rows.coeffs[name].shape[0] - 1}")
    return np.ascontiguousarray(
        np.stack([rows.coeffs[n].T for n in _FN_NAMES]), dtype=np.float32)


def _tables_on(tables: EAMTables, device):
    rows = tables.rows
    tab = torch.as_tensor(row_table(rows), device=device)
    return tab, row_map(rows, tables.cut)


def make_eam_rho_rows_cuda(geom: CellGeometry, tables: EAMTables,
                           dtype=torch.float32, device="cuda"):
    """rho_pass(x, evflag) -> (rho (M,), fp (M,), embed energy sum), the
    contract of ops/eam_rows.make_eam_rho_rows, through `eam_rho_rows`."""
    _check_geometry(geom, dtype)
    M, ncells = geom.nslots, geom.ncells
    tab, rmap = _tables_on(tables, device)
    frho = torch.as_tensor(np.ascontiguousarray(tables.frho_spline.T),
                           dtype=torch.float32, device=device)
    rdrho = 1.0 / tables.drho
    plain = make_eam_rho_rows(geom, tables, dtype, "cpu")
    zero = torch.zeros((), dtype=dtype, device=device)
    grid = _launch_args(geom, geom.nb)

    def rho_pass(x, evflag: bool):
        if x.device.type == "cpu":
            return plain(x, evflag)
        _check_tensor(x, "x", (3, M))
        if tab.device != x.device:
            raise ValueError(f"x on {x.device}, tables on {tab.device}")
        rho = torch.empty(M, dtype=torch.float32, device=x.device)
        fp = torch.empty(M, dtype=torch.float32, device=x.device)
        embed = (torch.empty(ncells, dtype=torch.float32, device=x.device)
                 if evflag else None)
        rc = _build.lib().eam_rho_rows_launch(
            x.data_ptr(), rho.data_ptr(), fp.data_ptr(),
            embed.data_ptr() if evflag else None, frho.data_ptr(),
            tables.nrho, rdrho, tab.data_ptr(), ctypes.addressof(rmap),
            *grid, VALID_BELOW, int(evflag),
            torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES["eam_rho_rows"] += 1
        _build.check(rc, "eam_rho_rows_launch")
        return rho, fp, torch.sum(embed) if evflag else zero

    return rho_pass


def make_eam_pair_rows_cuda(geom: CellGeometry, tables: EAMTables,
                            dtype=torch.float32, device="cuda"):
    """pair_pass(x, fp, evflag) -> (f (3, M), sum P, virial), the contract
    of ops/eam_rows.make_eam_pair_rows, through `eam_force_rows`."""
    _check_geometry(geom, dtype)
    M, ncells = geom.nslots, geom.ncells
    tab, rmap = _tables_on(tables, device)
    plain = make_eam_pair_rows(geom, tables, dtype, "cpu")
    zero = torch.zeros((), dtype=dtype, device=device)
    grid = _launch_args(geom, geom.nb)

    def pair_pass(x, fp, evflag: bool):
        if x.device.type == "cpu":
            return plain(x, fp, evflag)
        _check_tensor(x, "x", (3, M))
        _check_tensor(fp, "fp", (M,))
        if fp.device != x.device or tab.device != x.device:
            raise ValueError("x, fp and the tables on different devices")
        f = torch.empty((3, M), dtype=torch.float32, device=x.device)
        if evflag:
            eng = torch.empty(ncells, dtype=torch.float32, device=x.device)
            vir = torch.empty(ncells, dtype=torch.float32, device=x.device)
            eptr, vptr = eng.data_ptr(), vir.data_ptr()
        else:
            eptr = vptr = None
        rc = _build.lib().eam_force_rows_launch(
            x.data_ptr(), fp.data_ptr(), f.data_ptr(), eptr, vptr,
            tab.data_ptr(), ctypes.addressof(rmap), *grid, VALID_BELOW,
            int(evflag), torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES["eam_force_rows"] += 1
        _build.check(rc, "eam_force_rows_launch")
        if evflag:
            return f, torch.sum(eng), torch.sum(vir)
        return f, zero, zero

    return pair_pass


def make_eam_force_rows_cuda(geom: CellGeometry, tables: EAMTables,
                             dtype=torch.float32, device="cuda"):
    """Closures (force_ev, force_noev): (x, typ) -> (f (3, M), eng_vdwl,
    virial), the contract of ops/eam_cuda.make_eam_force_cuda. Raises
    ValueError for what the kernels do not take."""
    return two_pass_force(
        make_eam_rho_rows_cuda(geom, tables, dtype, device),
        make_eam_pair_rows_cuda(geom, tables, dtype, device))
