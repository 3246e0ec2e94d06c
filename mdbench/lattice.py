"""The benchmark's inputs, made from the seed: miniMD's set-up rule
(ref/setup.cpp, ref/atom.cpp) with the seed in place of the deck's fixed
Park-Miller and glibc streams.

Atoms sit on an FCC lattice of nx x ny x nz unit cells at the
configuration's density. From the seed come each atom's type (uniform
over the configuration's ntypes) and velocity (uniform in [-1/2, 1/2)
per component), then the velocities lose their net momentum and are
scaled to the configuration's temperature. Every seed gives the same
lattice, box and number of atoms, so the work of a cell does not depend
on the seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import reference

_BASIS = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                   [0.0, 0.5, 0.5]])


@dataclasses.dataclass
class Inputs:
    box: tuple[float, float, float]
    x: np.ndarray      # (N, 3) float64
    v: np.ndarray      # (N, 3) float64
    typ: np.ndarray    # (N,) int32
    mass: float

    @property
    def natoms(self) -> int:
        return len(self.x)

    def type_counts(self, ntypes: int) -> np.ndarray:
        return np.bincount(self.typ, minlength=ntypes)


def fcc(nx: int, ny: int, nz: int, rho: float):
    """(x (4 nx ny nz, 3), box) of an FCC lattice at number density rho."""
    a = (4.0 / rho) ** (1.0 / 3.0)
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    cells = np.stack([i, j, k], axis=-1).reshape(-1, 1, 3).astype(float)
    x = ((cells + _BASIS[None]) * a).reshape(-1, 3)
    return x, (nx * a, ny * a, nz * a)


def make_inputs(cfg: dict, lattice, seed: int, mass: float) -> Inputs:
    """The inputs of one run: the lattice of `lattice` (nx, ny, nz) unit
    cells, with types and velocities drawn from `seed` (any integer)."""
    x, box = fcc(*lattice, cfg["density"])
    n = len(x)
    rng = np.random.default_rng(seed % (1 << 64))
    typ = rng.integers(0, cfg["ntypes"], size=n, dtype=np.int32)
    v = rng.random((n, 3)) - 0.5
    v -= v.mean(axis=0)
    sc = reference.scales(cfg["units"], n, float(np.prod(box)))
    t = float((v * v).sum()) * mass * sc.t_scale
    v *= np.sqrt(cfg["temperature"] / t)
    return Inputs(box=box, x=x, v=v, typ=typ, mass=mass)
