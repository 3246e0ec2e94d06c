"""The fused LJ velocity-Verlet step, plain PyTorch: the plain version of
the fused-step kernel (ops/lj_step_cuda.py) and the CPU path of
Simulation(fused_step=True), in any dtype.

The counterpart of minimd_tpu/ops/lj_step_pallas.py. Its phase convention
(a half-step shift): a fused step takes (x_k, w_k), where w_k is the
half-kick velocity that drifted into x_k, and computes

    f       = F(x_k)                  (the LJ force, ops/lj_grid.py)
    v_k     = w_k + dtf*f             (the step-k velocity; thermo reads it)
    w_{k+1} = v_k + dtf*f             (two sequential kicks, each rounded
                                       as the reference's final and initial
                                       integrate round them)
    x_{k+1} = x_k + dt*w_{k+1}

and on ev steps the energy, the virial and vsq = sum v_k . v_k (in
float64, as thermo.temperature sums). `seed` makes (x_1, w_1) from the
(x, v, f) a reneighbor step leaves; after the interval's fused steps,
(x, w) is exactly the (position, half-kick velocity) pair the
reneighbor step's rebin takes.

There is no candidate pack: the TPU kernel re-packs x_{k+1} into its
lane-packed candidate rows for the next step (lj_step_pallas.py:133-170,
:267-269); the port's kernels read the raw cell-major grid, so that part
has no counterpart.
"""

from __future__ import annotations

import torch

from ..cells import CellGeometry
from ..thermo import ordered_sum
from .lj import LJParams
from .lj_grid import make_lj_force_grid


def make_lj_step_plain(geom: CellGeometry, params: LJParams, dt: float,
                       dtforce: float, dtype=torch.float32, device="cpu"):
    """Returns (step, seed):

    - step(x, w, evflag, out=None) -> (x_next, w_next, eng, vir, vsq):
      one fused step; eng, vir and vsq are 0 without evflag. x_next is
      written into `out` when given (the kernel's ping-pong buffer).
    - seed(x, v, f) -> (x_1, w_1): the interval's first kick and drift.
    """
    if not params.uniform:
        raise ValueError("the fused LJ step needs type-uniform LJ parameters")
    force_ev, force_noev = make_lj_force_grid(geom, params, dtype, device)
    vsq0 = torch.zeros((), dtype=torch.float64, device=device)

    def step(x, w, evflag: bool, out=None):
        f, eng, vir = (force_ev if evflag else force_noev)(x, None)
        v = w + dtforce * f
        w_next = v + dtforce * f
        x_next = torch.add(x, dt * w_next, out=out)
        vsq = (ordered_sum(v * v, dtype=torch.float64) if evflag
               else vsq0)
        return x_next, w_next, eng, vir, vsq

    def seed(x, v, f):
        w = v + dtforce * f
        return x + dt * w, w

    return step, seed
