"""LAMMPS data-file reader (ref/setup.cpp:55-301).

Parses the header (natoms, atom types, box bounds) and the Atoms /
Velocities / Masses sections. Returns host NumPy arrays; used by the
`-f/--data_file` path and the in.*-data.miniMD decks. A copy of the reader
of minimd_tpu.lammps_data without its native fast path.
"""

from __future__ import annotations

import pathlib

import numpy as np

from .create import Box

_SECTIONS = ("Atoms", "Velocities", "Masses")


def read_lammps_data(path: str | pathlib.Path):
    """Returns (box, x, v, mass). Atom ids in the file are 1-based and may
    be unordered; rows are scattered by id like the reference
    (setup.cpp:169-189)."""
    lines = pathlib.Path(path).read_text().splitlines()

    # Two-state parse: header lines (keyword suffixes) until the first
    # section title, then data rows routed by the current section. Comments
    # (# ...) and blank lines are stripped everywhere, so decks with
    # annotated section headers parse the same as bare ones.
    natoms = 0
    xlo = xhi = ylo = yhi = zlo = zhi = 0.0
    x = v = None
    mass = 1.0
    section = None

    for ln in lines[1:]:  # first line is the title
        s = ln.split("#")[0].strip()
        if not s:
            continue
        parts = s.split()
        if parts[0] in _SECTIONS:
            section = parts[0]
            if x is None:
                x = np.zeros((natoms, 3))
                v = np.zeros((natoms, 3))
            continue
        if section is None:  # header
            if len(parts) == 2 and parts[1] == "atoms":
                natoms = int(parts[0])
            elif len(parts) == 4 and parts[2:] == ["xlo", "xhi"]:
                xlo, xhi = float(parts[0]), float(parts[1])
            elif len(parts) == 4 and parts[2:] == ["ylo", "yhi"]:
                ylo, yhi = float(parts[0]), float(parts[1])
            elif len(parts) == 4 and parts[2:] == ["zlo", "zhi"]:
                zlo, zhi = float(parts[0]), float(parts[1])
            # "N atom types" and any other header counts: type ids are
            # regenerated by the caller (the reference does the same,
            # setup.cpp assigns rand()%ntypes regardless of the file)
        elif section == "Atoms":
            x[int(parts[0]) - 1] = [float(parts[2]), float(parts[3]),
                                    float(parts[4])]
        elif section == "Velocities":
            v[int(parts[0]) - 1] = [float(parts[1]), float(parts[2]),
                                    float(parts[3])]
        elif section == "Masses":
            mass = float(parts[1])

    if x is None:
        raise ValueError(f"{path}: no Atoms section found")
    box = Box(xhi - xlo, yhi - ylo, zhi - zlo)
    box.xhi, box.yhi, box.zhi = box.xprd, box.yprd, box.zprd
    return box, x, v, mass

