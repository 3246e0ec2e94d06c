"""Write a LAMMPS data file for the -f/--data_file path: an FCC lattice
with Park-Miller velocities in any (possibly non-cubic) box.

    python -m minimd_torch.make_data --nx 64 --ny 32 --nz 128 \\
        --rho 0.058464 -o 1m.data

The port's counterpart of scripts/make_data.py: the same arguments, the
same output line and the same file for the same arguments. The reference's
1m.data (1,048,576 atoms in a 261.76 x 130.88 x 523.52 box,
tests/golden/1049k.lj-data) is not in the repository; the line above
writes a lattice of that size in that box.

The velocities are scaled to --temp in LJ units (thermo_scales(UNITS_LJ,
...)), as the JAX script does; there is no --units. A metal-unit lattice
(the EAM deck's) therefore cannot be written at its temperature: --rho
and --mass give its positions and mass, but --temp is read in LJ units.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import create
from .config import UNITS_LJ
from .lammps_data import write_lammps_data
from .units import thermo_scales


def make_system(nx: int, ny: int, nz: int, rho: float, temp: float,
                mass: float):
    """(box, x, v): the lattice and the velocities the file holds."""
    box = create.create_box(nx, ny, nz, rho)
    x, v = create.create_atoms(nx, ny, nz, rho, box)
    sc = thermo_scales(UNITS_LJ, len(x), box.volume)
    v = create.create_velocity(v, temp, len(x), mass, sc.t_scale)
    return box, x, v


def main(argv=None) -> tuple[create.Box, np.ndarray, np.ndarray]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=32)
    ap.add_argument("--nz", type=int, default=128)
    ap.add_argument("--rho", type=float, default=0.8442)
    ap.add_argument("--temp", type=float, default=1.44)
    ap.add_argument("--mass", type=float, default=1.0)
    ap.add_argument("-o", "--output", default="system.data")
    args = ap.parse_args(argv)

    box, x, v = make_system(args.nx, args.ny, args.nz, args.rho, args.temp,
                            args.mass)
    write_lammps_data(args.output, box, x, v, mass=args.mass)
    print(f"wrote {args.output}: {len(x)} atoms, box "
          f"{box.xprd:.2f} x {box.yprd:.2f} x {box.zprd:.2f}")
    return box, x, v


if __name__ == "__main__":
    main()
