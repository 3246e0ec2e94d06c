"""Local (one-hot pull) rebin through the hand-written CUDA kernel
(csrc/rebin_pull.cu), the counterpart of minimd_tpu/ops/rebin_pallas.py.

The kernel does the placement, with the contract of the plain
cells.rebin_pull: pull(cid, chans) -> (outs, counts, cap_overflow),
bit-identical to it. The elementwise work around it (wrap, cell id,
movement guard, sentinels on unoccupied slots) stays plain torch, shared
with the plain path through cells.rebin_local. On a CPU tensor the pull
takes the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..cells import MAX_CAPACITY, CellGeometry, rebin_local, rebin_pull

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def make_rebin_cuda(geom: CellGeometry, device="cuda"):
    """Returns rebin(x, v, typ) -> (x, v, typ, overflow), the contract of
    cells.rebin_local. Its placement core is `rebin.pull`."""
    del device  # outputs follow the inputs' device
    if min(geom.nb) < 3:
        raise ValueError(f"the pull rebin needs min(nb) >= 3, got {geom.nb}")
    if geom.capacity > MAX_CAPACITY:
        raise ValueError(f"capacity {geom.capacity} > {MAX_CAPACITY}")
    nbx, nby, nbz = geom.nb
    C, M, ncells = geom.capacity, geom.nslots, geom.ncells

    def pull(cid, chans):
        global LAUNCHES
        if cid.device.type == "cpu":
            return rebin_pull(cid, chans, geom)
        if len(chans) != 7:
            raise ValueError("chans must be x0 x1 x2 v0 v1 v2 typ")
        want = [torch.int32] + [torch.float32] * 6 + [torch.int32]
        for t, dt in zip([cid, *chans], want):
            if t.dtype != dt or tuple(t.shape) != (M,) or not t.is_contiguous():
                raise ValueError(f"rebin pull expects contiguous ({M},) "
                                 f"{dt}, got {t.dtype} {tuple(t.shape)}")
            if t.device != cid.device:
                raise ValueError("rebin pull inputs on different devices")
        outs = [torch.empty((ncells, C), dtype=c.dtype, device=cid.device)
                for c in chans]
        counts = torch.empty(ncells, dtype=torch.int32, device=cid.device)
        cap_ovf = torch.zeros((), dtype=torch.int32, device=cid.device)
        rc = _build.lib().rebin_pull_launch(
            cid.data_ptr(), *(c.data_ptr() for c in chans),
            *(o.data_ptr() for o in outs), counts.data_ptr(),
            cap_ovf.data_ptr(), nbx, nby, nbz, C,
            torch.cuda.current_stream(cid.device).cuda_stream)
        LAUNCHES += 1
        _build.check(rc, "rebin_pull_launch")
        return outs, counts, cap_ovf

    def rebin(x, v, typ):
        return rebin_local(x, v, typ, geom, pull=pull)

    rebin.pull = pull
    return rebin
