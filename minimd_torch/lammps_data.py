"""LAMMPS data files (ref/setup.cpp:55-301): the reader and the writer.

The reader parses the header (natoms, atom types, box bounds) and the
Atoms / Velocities / Masses sections and returns host NumPy arrays; the
`-f/--data_file` path and the in.*-data.miniMD decks use it. A copy of
minimd_tpu.lammps_data. `read_lammps_data` runs the host runtime
(csrc/native.cpp) on every call; `read_lammps_data_plain` is its numpy
version, line for line the same rules and the same arrays. Both refuse an
atom id outside 1..natoms and a row with fewer columns than its section
needs, and take the mass from the last row of a Masses section.
"""

from __future__ import annotations

import pathlib

import numpy as np

from .create import Box

_SECTIONS = ("Atoms", "Velocities", "Masses")
# the columns a row of each section needs (Atoms: id type x y z)
_COLUMNS = {"Atoms": 5, "Velocities": 4, "Masses": 2}
# rows a writer formats in one string
_WRITE_ROWS = 1 << 16


def _box(xprd: float, yprd: float, zprd: float) -> Box:
    box = Box(xprd, yprd, zprd)
    box.xhi, box.yhi, box.zhi = box.xprd, box.yprd, box.zprd
    return box


def read_lammps_data(path: str | pathlib.Path):
    """Returns (box, x, v, mass). Atom ids in the file are 1-based and may
    be unordered; rows are scattered by id like the reference
    (setup.cpp:169-189). Raises ValueError for an id outside 1..natoms or
    a short row."""
    from . import native

    prd, x, v, mass = native.read_lammps_data(path)
    return _box(float(prd[0]), float(prd[1]), float(prd[2])), x, v, mass


def read_lammps_data_plain(path: str | pathlib.Path):
    """`read_lammps_data` in Python and numpy, the same arrays bit for
    bit."""
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

    for n, ln in enumerate(lines[1:], 2):  # first line is the title
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
            continue
        if len(parts) < _COLUMNS[section]:
            raise ValueError(f"{path} (line {n}): a row with fewer columns "
                             "than its section needs")
        if section == "Masses":
            mass = float(parts[1])   # the last row wins
            continue
        first = 2 if section == "Atoms" else 1
        row = [float(c) for c in parts[first:first + 3]]
        i = int(parts[0])
        if not 1 <= i <= natoms:
            raise ValueError(f"{path} (line {n}): an atom id outside "
                             "1..natoms")
        (x if section == "Atoms" else v)[i - 1] = row

    if x is None:
        raise ValueError(f"{path}: no Atoms section found")
    return _box(xhi - xlo, yhi - ylo, zhi - zlo), x, v, mass


def _write_rows(f, fmt: str, ids: np.ndarray, cols: np.ndarray) -> None:
    """One `fmt` line per row (id, three float64 columns), formatted
    `_WRITE_ROWS` rows to a string."""
    for a in range(0, len(ids), _WRITE_ROWS):
        k = min(_WRITE_ROWS, len(ids) - a)
        flat = [None] * (4 * k)
        flat[0::4] = ids[a:a + k].tolist()
        for c in range(3):
            flat[c + 1::4] = cols[a:a + k, c].tolist()
        f.write((fmt * k) % tuple(flat))


def write_lammps_data(path, box: Box, x: np.ndarray, v: np.ndarray,
                      mass: float = 1.0, ntypes: int = 1):
    """Writer counterpart (the reference has none): the JAX package's
    writer, byte for byte. `.17g` round-trips every float64, so the reader
    gives back x, v and the box edges exactly (xlo is written as 0.0)."""
    x = np.asarray(x, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    n = len(x)
    ids = np.arange(1, n + 1)
    with open(path, "w") as f:
        f.write("LAMMPS data file (minimd-tpu)\n\n")
        f.write(f"{n} atoms\n{ntypes} atom types\n\n")
        f.write(f"0.0 {box.xprd:.17g} xlo xhi\n")
        f.write(f"0.0 {box.yprd:.17g} ylo yhi\n")
        f.write(f"0.0 {box.zprd:.17g} zlo zhi\n\n")
        f.write("Masses\n\n")
        f.write(f"1 {mass:.6g}\n\n")
        f.write("Atoms\n\n")
        _write_rows(f, "%d 1 %.17g %.17g %.17g\n", ids, x)
        f.write("\nVelocities\n\n")
        _write_rows(f, "%d %.17g %.17g %.17g\n", ids, v)
