"""The fused LJ step through the hand-written CUDA kernel
(csrc/lj_step.cu), the counterpart of minimd_tpu/ops/lj_step_pallas.py.

One launch per plain MD step: the LJ force, both kicks and the drift. The
kernel reads x_k from one (3, M) buffer and writes x_{k+1} into another
(positions ping-pong, see csrc/lj_step.cu), and updates w in place. It
takes what the LJ kernel takes (f32, stencil reach 1, type-uniform
parameters, any capacity C). On a CPU tensor the step takes the plain
version (ops/lj_step.py); on a CUDA tensor it launches the kernel or
raises. `seed` is plain torch on either device (once per interval).
"""

from __future__ import annotations

import torch

from .. import _build
from ..cells import VALID_BELOW, CellGeometry
from .lj import LJParams
from .lj_cuda import check_lj_kernel_inputs
from .lj_step import make_lj_step_plain

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def make_lj_step_cuda(geom: CellGeometry, params: LJParams, dt: float,
                      dtforce: float, dtype=torch.float32, device="cuda"):
    """(step, seed), the contract of ops/lj_step.make_lj_step_plain. On the
    card, step(x, w, evflag, out) writes x_next into `out` (allocated when
    None; it must not be x) and w_next into w itself. Raises ValueError for
    what the kernel does not take."""
    check_lj_kernel_inputs(geom, params, dtype)
    nbx, nby, nbz = geom.nb
    C, M, ncells = geom.capacity, geom.nslots, geom.ncells
    prd = [float(p) for p in geom.prd]
    cutsq, eps, sig6 = (float(params.cutforcesq[0]), float(params.epsilon[0]),
                        float(params.sigma6[0]))
    plain_step, seed = make_lj_step_plain(geom, params, dt, dtforce, dtype,
                                          "cpu")
    zero = torch.zeros((), dtype=dtype, device=device)
    vsq0 = torch.zeros((), dtype=torch.float64, device=device)

    def step(x, w, evflag: bool, out=None):
        global LAUNCHES
        if x.device.type == "cpu":
            return plain_step(x, w, evflag, out)
        if out is None:
            out = torch.empty_like(x)
        for name, t in (("x", x), ("w", w), ("out", out)):
            if (t.dtype != torch.float32 or tuple(t.shape) != (3, M)
                    or not t.is_contiguous() or t.device != x.device):
                raise ValueError(f"{name} must be contiguous float32 (3, {M}) "
                                 f"on {x.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if out.data_ptr() == x.data_ptr():
            raise ValueError("out must be another buffer than x: positions "
                             "ping-pong (csrc/lj_step.cu)")
        if evflag:
            parts = torch.empty((3, ncells), dtype=torch.float32,
                                device=x.device)
            pptr = [parts[q].data_ptr() for q in range(3)]
        else:
            pptr = [None] * 3
        rc = _build.lib().lj_step_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), *pptr, nbx, nby, nbz,
            C, *prd, cutsq, eps, sig6, dt, dtforce, VALID_BELOW, int(evflag),
            torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES += 1
        _build.check(rc, "lj_step_launch")
        if evflag:
            return (out, w, torch.sum(parts[0]), torch.sum(parts[1]),
                    torch.sum(parts[2], dtype=torch.float64))
        return out, w, zero, zero, vsq0

    return step, seed
