"""Deterministic system setup: box, FCC lattice, velocities, types.

Reproduces the reference's setup semantics bit-for-bit where it matters for
golden-trace parity (ref/setup.cpp:305-517):

- box edge = n * (4/rho)^(1/3)                      (setup.cpp:305-311)
- 4*nx*ny*nz atoms on an FCC lattice, emitted in the reference's
  subbox-blocked traversal order                    (setup.cpp:315-422)
- per-site Park-Miller velocities, seeded by the global lattice site index,
  5 warmup draws per component                      (setup.cpp:378-391)
- type[i] = glibc rand()%ntypes with srand(5413)    (atom.cpp:97, ljs.cpp:110)
- COM-zeroed, temperature-rescaled velocities       (setup.cpp:454-494)

Everything here is host-side NumPy (float64): setup runs once; the device
only ever sees the finished arrays. A copy of minimd_tpu.create without
its native (C++ host runtime) fast path, whose numpy path gives the same
arrays; the EAM mass comes from the port's own eam_file.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .rng import GlibcRand, park_miller_velocity_triplet

_SUBBOX = 8  # reference's lattice traversal block size (setup.cpp:355)


@dataclasses.dataclass
class Box:
    xprd: float
    yprd: float
    zprd: float
    # local subdomain bounds (equal to the full box on a single device)
    xlo: float = 0.0
    xhi: float = 0.0
    ylo: float = 0.0
    yhi: float = 0.0
    zlo: float = 0.0
    zhi: float = 0.0

    @property
    def prd(self) -> np.ndarray:
        return np.array([self.xprd, self.yprd, self.zprd], dtype=np.float64)

    @property
    def volume(self) -> float:
        return self.xprd * self.yprd * self.zprd


def create_box(nx: int, ny: int, nz: int, rho: float) -> Box:
    lattice = (4.0 / rho) ** (1.0 / 3.0)
    b = Box(nx * lattice, ny * lattice, nz * lattice)
    b.xhi, b.yhi, b.zhi = b.xprd, b.yprd, b.zprd
    return b


def _blocked_site_order(ihi, jhi, khi):
    """Lattice site indices (i, j, k) in the reference's traversal order.

    The reference walks 8x8x8 sub-blocks: within a block sx varies fastest,
    then sy, then sz; blocks advance ox fastest, then oy, then oz
    (setup.cpp:355-421). Returns int arrays of every site visited (before the
    parity / bounds filters).
    """
    nbx = ihi // _SUBBOX + 1
    nby = jhi // _SUBBOX + 1
    nbz = khi // _SUBBOX + 1
    # order: oz, oy, ox, sz, sy, sx  (sx fastest)
    oz, oy, ox, sz, sy, sx = np.meshgrid(
        np.arange(nbz), np.arange(nby), np.arange(nbx),
        np.arange(_SUBBOX), np.arange(_SUBBOX), np.arange(_SUBBOX),
        indexing="ij",
    )
    i = (ox * _SUBBOX + sx).ravel()
    j = (oy * _SUBBOX + sy).ravel()
    k = (oz * _SUBBOX + sz).ravel()
    return i, j, k


def create_atoms(
    nx: int,
    ny: int,
    nz: int,
    rho: float,
    box: Box,
    bounds: tuple[float, float, float, float, float, float] | None = None,
):
    """Generate (x, v) float64 arrays for the FCC lattice inside `bounds`.

    `bounds` defaults to the whole box (single-device). With a subdomain
    it generates only that slab's atoms, in the same per-rank order the
    reference uses — so a sharded setup is bit-identical to the MPI one.
    """
    if bounds is None:
        bounds = (0.0, box.xprd, 0.0, box.yprd, 0.0, box.zprd)
    xlo, xhi, ylo, yhi, zlo, zhi = bounds

    alat = (4.0 / rho) ** (1.0 / 3.0)
    half = 0.5 * alat

    ilo = max(int(xlo / half - 1), 0)
    ihi = min(int(xhi / half + 1), 2 * nx - 1)
    jlo = max(int(ylo / half - 1), 0)
    jhi = min(int(yhi / half + 1), 2 * ny - 1)
    klo = max(int(zlo / half - 1), 0)
    khi = min(int(zhi / half + 1), 2 * nz - 1)

    i, j, k = _blocked_site_order(ihi, jhi, khi)
    keep = (
        ((i + j + k) % 2 == 0)
        & (i >= ilo) & (i <= ihi)
        & (j >= jlo) & (j <= jhi)
        & (k >= klo) & (k <= khi)
    )
    i, j, k = i[keep], j[keep], k[keep]

    xt = half * i.astype(np.float64)
    yt = half * j.astype(np.float64)
    zt = half * k.astype(np.float64)
    inbox = (
        (xt >= xlo) & (xt < xhi)
        & (yt >= ylo) & (yt < yhi)
        & (zt >= zlo) & (zt < zhi)
    )
    i, j, k = i[inbox], j[inbox], k[inbox]
    x = np.stack([xt[inbox], yt[inbox], zt[inbox]], axis=1)

    # per-site velocity seed: global lattice index + 1 (setup.cpp:378)
    seed = (k.astype(np.int64) * (2 * ny) * (2 * nx)
            + j.astype(np.int64) * (2 * nx) + i.astype(np.int64) + 1)
    vx, vy, vz = park_miller_velocity_triplet(seed)
    v = np.stack([vx, vy, vz], axis=1)
    return x, v


def assign_types(nlocal: int, ntypes: int, seed: int = 5413) -> np.ndarray:
    """glibc rand()%ntypes per atom, in insertion order (atom.cpp:97)."""
    return GlibcRand(seed).rand_array(nlocal, ntypes)


def create_velocity(
    v: np.ndarray,
    t_request: float,
    natoms: int,
    mass: float,
    t_scale: float,
    vsum_global: np.ndarray | None = None,
    t_current_global: float | None = None,
) -> np.ndarray:
    """Zero COM momentum, then rescale to the requested temperature.

    (setup.cpp:454-494). The *_global arguments let a sharded setup pass in
    all-device reductions; on a single device they default to local sums.
    """
    vsum = v.sum(axis=0) if vsum_global is None else np.asarray(vsum_global)
    v = v - vsum / natoms
    if t_current_global is None:
        t = float((v * v).sum() * mass * t_scale)
    else:
        t = t_current_global
    factor = np.sqrt(t_request / t)
    return v * factor


def setup_system(inp, ntypes: int = 4, potential_path: str | None = None):
    """Deck -> (prd, x, v, typ, mass): the reference's deterministic setup
    sequence (ljs.cpp:385-468) — box + FCC lattice (or LAMMPS data file),
    seeded type assignment, EAM mass from the potential file, COM-zero +
    rescale velocities for generated systems (setup.cpp:454-494)."""
    from .config import FORCE_EAM

    if inp.datafile is not None:
        from .lammps_data import read_lammps_data
        box, x, v, mass = read_lammps_data(inp.datafile)
    else:
        box = create_box(inp.nx, inp.ny, inp.nz, inp.rho)
        x, v = create_atoms(inp.nx, inp.ny, inp.nz, inp.rho, box)
        mass = 1.0
    natoms = len(x)
    typ = assign_types(natoms, ntypes)

    if inp.forcetype == FORCE_EAM:
        from .eam_file import default_potential_path, read_funcfl
        mass = read_funcfl(potential_path or default_potential_path()).mass

    if inp.datafile is None:  # data files carry velocities
        from .units import thermo_scales
        scales = thermo_scales(inp.units, natoms, box.volume)
        v = create_velocity(v, inp.t_request, natoms, mass, scales.t_scale)
    return box.prd, x, v, typ, mass
