"""The whole local rebin through the hand-written CUDA kernels
(csrc/rebin.cu), the counterpart of minimd_tpu/ops/rebin_pallas.py's
make_rebin_pallas (the pull kernels and the glue around them).

rebin(x, v, typ) -> (x, v, typ, overflow) is cells.rebin_local's
contract, bit for bit: wrap, cell id, movement guard, placement and
sentinels in two launches (rebin_bin, rebin_gather), with the overflow
(movers + capacity overflow) left on the device. The
kernels take RebinConstants' f32 values as scalars, so a rebin copies
nothing from the host. On a CPU tensor it takes the plain
cells.rebin_local; on a CUDA tensor it launches the kernels or raises.
cells.rebin_push is the plain mirror of the two phases, for the tests.
"""

from __future__ import annotations

import torch

from .. import _build
from ..cells import (MAX_CAPACITY, VALID_BELOW, CellGeometry, cell_columns,
                     rebin_local)

# Rebins through the kernels since import (or since a caller reset it to
# 0); each is one launch of each of the two phases.
LAUNCHES = 0


def make_rebin_cuda(geom: CellGeometry, device="cuda"):
    """Returns rebin(x, v, typ) -> (x, v, typ, overflow), the contract of
    cells.rebin_local, for float32 positions on `device` (on "cpu" the
    plain rebin_local runs). Raises ValueError for tensors on another
    device and for what the kernels do not take."""
    if min(geom.nb) < 3:
        raise ValueError(f"the local rebin needs min(nb) >= 3, got {geom.nb}")
    if geom.capacity > MAX_CAPACITY:
        raise ValueError(f"capacity {geom.capacity} > {MAX_CAPACITY}")
    device = torch.device(device)
    nbx, nby, nbz = geom.nb
    C, M, ncells = geom.capacity, geom.nslots, geom.ncells
    # the f32 prd, offset and 1/binsize that RebinConstants holds
    prd, off, inv, _ = cell_columns(geom, torch.float32, "cpu")
    consts = [float(a) for col in (prd, off, inv) for a in col[:, 0]]

    def rebin(x, v, typ):
        global LAUNCHES
        if x.device.type != device.type or device.index not in (
                None, x.device.index):
            raise ValueError(f"rebin made for {device}, x is on {x.device}")
        if x.device.type == "cpu":
            return rebin_local(x, v, typ, geom)
        for t, dt, shape in ((x, torch.float32, (3, M)),
                             (v, torch.float32, (3, M)),
                             (typ, torch.int32, (M,))):
            if (t.dtype != dt or tuple(t.shape) != shape
                    or not t.is_contiguous() or t.device != x.device):
                raise ValueError(
                    f"the rebin kernels take contiguous {dt} {shape} on "
                    f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        x_out, v_out = torch.empty_like(x), torch.empty_like(v)
        t_out = torch.empty_like(typ)
        scratch = torch.empty(M + 27 * ncells, dtype=torch.int32,
                              device=x.device)
        overflow = torch.empty((), dtype=torch.int32, device=x.device)
        rc = _build.lib().rebin_launch(
            x.data_ptr(), v.data_ptr(), typ.data_ptr(), x_out.data_ptr(),
            v_out.data_ptr(), t_out.data_ptr(), scratch.data_ptr(),
            overflow.data_ptr(), nbx, nby, nbz, C, *consts, VALID_BELOW,
            torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES += 1
        _build.check(rc, "rebin_launch")
        return x_out, v_out, t_out, overflow

    return rebin
