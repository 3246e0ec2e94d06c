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
from .._build import on_device
from ..cells import (VALID_BELOW, CellGeometry, cell_columns, is_valid,
                     rebin_local)

# Rebins through the kernels since import (or since a caller reset it to
# 0); each is one launch of each of the two phases. SHARDED_LAUNCHES
# counts the sharded form's (a domain's residents in a migration).
LAUNCHES = 0
SHARDED_LAUNCHES = 0
# csrc/rebin.cu kSharedKeys: past this capacity the kernels keep a cell's
# keys in the scratch, which then holds twice the ints
SHARED_KEYS = 512


def make_rebin_cuda(geom: CellGeometry, device="cuda", nb_local=None,
                    decomposed=None):
    """Returns rebin(x, v, typ) -> (x, v, typ, overflow), the contract of
    cells.rebin_local, for float32 positions on `device` (on "cpu" the
    plain rebin_local runs). Raises ValueError for tensors on another
    device and for what the kernels do not take.

    The sharded form (nb_local, decomposed: per axis x, y, z) places one
    domain's residents in a decomposed run: rebin(x, v, typ, origin,
    slot0) -> (x, v, typ, counts, moved, capacity), the contract of
    parallel/comm.place_residents with validity read from the sentinels
    (the migration writes sentinels into its leavers' slots); origin is
    the domain's first global cell per axis, slot0 = domain * M_local the
    first slot of its sentinels (comm.domain_sentinels). The decomposed axes do not
    wrap; the others need 3 cells or more."""
    sharded = nb_local is not None
    nb = tuple(nb_local) if sharded else geom.nb
    dec = tuple(bool(d) for d in (decomposed or (False,) * 3))
    if any(n < 3 and not d for n, d in zip(nb, dec)):
        raise ValueError(f"the local rebin needs 3 cells or more on the "
                         f"axes that wrap, got {nb}")
    device = torch.device(device)
    nbx, nby, nbz = nb
    C = geom.capacity
    ncells = nbx * nby * nbz
    M = ncells * C
    dead = sum(1 << a for a in range(3) if dec[a])
    # the f32 prd, offset and 1/binsize that RebinConstants holds
    prd, off, inv, _ = cell_columns(geom, torch.float32, "cpu")
    consts = [float(a) for col in (prd, off, inv) for a in col[:, 0]]

    def launch(x, v, typ, origin, slot0):
        global LAUNCHES, SHARDED_LAUNCHES
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
        scratch = torch.empty((M + 27 * ncells) * (1 + (C > SHARED_KEYS)),
                              dtype=torch.int32, device=x.device)
        overflow = torch.empty(2 if sharded else (), dtype=torch.int32,
                               device=x.device)
        counts = (torch.empty(ncells, dtype=torch.int32, device=x.device)
                  if sharded else None)
        # a sharded launch may run on another card than the current
        with on_device(x.device, sharded):
            rc = _build.lib().rebin_launch(
                x.data_ptr(), v.data_ptr(), typ.data_ptr(), x_out.data_ptr(),
                v_out.data_ptr(), t_out.data_ptr(), scratch.data_ptr(),
                overflow.data_ptr(), counts.data_ptr() if sharded else None,
                nbx, nby, nbz, C, *consts, VALID_BELOW, *geom.nb, *origin,
                dead, int(sharded), slot0,
                torch.cuda.current_stream(x.device).cuda_stream)
        if sharded:
            SHARDED_LAUNCHES += 1
        else:
            LAUNCHES += 1
        _build.check(rc, "rebin_launch")
        if sharded:
            return x_out, v_out, t_out, counts, overflow[0], overflow[1]
        return x_out, v_out, t_out, overflow

    def check_device(x):
        if x.device.type != device.type or device.index not in (
                None, x.device.index):
            raise ValueError(f"rebin made for {device}, x is on {x.device}")

    def rebin(x, v, typ):
        check_device(x)
        if x.device.type == "cpu":
            return rebin_local(x, v, typ, geom)
        return launch(x, v, typ, (0, 0, 0), 0)

    def rebin_sharded(x, v, typ, origin, slot0):
        check_device(x)
        if x.device.type == "cpu":
            from ..parallel.comm import (dead_pads, domain_sentinels,
                                         place_residents)
            return place_residents(
                x, v, typ, is_valid(x), geom, nb, origin, dec,
                dead_pads(dec), domain_sentinels(M, slot0 // M, x.dtype,
                                                 x.device))
        return launch(x, v, typ, tuple(int(o) for o in origin), int(slot0))

    return rebin_sharded if sharded else rebin
