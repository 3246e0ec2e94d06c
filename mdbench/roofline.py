"""The yardstick of the kernels' rooflines: the card's peaks and the work
a force or a rebin needs, counted on the atoms and on the unordered pairs
inside the cutoff, so that it reads the same whatever implements it.

The counts are chip_smoke.py's per-pair rules (an FMA counts 2), restated
for one unordered pair: a pair is evaluated once and its force added to
both atoms.
"""

from __future__ import annotations

# NVIDIA H100 SXM at its 700 W limit: FP32 outside the tensor cores, HBM3
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES = 3.35e12

_DIST = 8          # 3 sub, 3 mul, 2 add
_FSUM = 6          # one atom's force sum: 3 FMA
_ROW_MAP = 8       # a spline row from r: the index map
_CUBIC = 6         # a cubic by Horner: 3 FMA
_QUAD = 4          # its derivative: 2 FMA

# LJ: distance, sr2 (div), sr6 (5), fc (4), the force to both atoms
LJ_PAIR_OPS = _DIST + 1 + 5 + 4 + 2 * _FSUM
# EAM density pass: distance, sqrt, the row, rho(r), add to both atoms
EAM_RHO_PAIR_OPS = _DIST + 1 + _ROW_MAP + _CUBIC + 2
# EAM embedding per atom: the row, F(rho), F'(rho)
EAM_EMBED_ATOM_OPS = _ROW_MAP + _CUBIC + _QUAD
# EAM force pass: distance, sqrt, the row, rho'(r), z2(r), z2'(r),
# 1/r, phi, phi' (3), psi' (add, FMA), fpair, the force to both atoms
EAM_FORCE_PAIR_OPS = (_DIST + 1 + _ROW_MAP + _QUAD + _CUBIC + _QUAD + 1 + 1
                      + 3 + 3 + 1 + 2 * _FSUM)

# bytes a force reads and writes per atom: x in, f out (3 float32 each)
FORCE_ATOM_BYTES = 24
# a rebin reads and writes each atom's x, v (3 float32) and type (int32)
REBIN_ATOM_BYTES = 2 * (12 + 12 + 4)


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """(seconds, what bounds it): the larger of the two least times."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS_FP32
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def lj_force(natoms: int, pairs: int) -> tuple[float, str]:
    return bound_s(FORCE_ATOM_BYTES * natoms, LJ_PAIR_OPS * pairs)


def eam_force(natoms: int, pairs: int) -> tuple[float, str]:
    flops = ((EAM_RHO_PAIR_OPS + EAM_FORCE_PAIR_OPS) * pairs
             + EAM_EMBED_ATOM_OPS * natoms)
    return bound_s(FORCE_ATOM_BYTES * natoms, flops)


def rebin(natoms: int) -> tuple[float, str]:
    return bound_s(REBIN_ATOM_BYTES * natoms, 0.0)
