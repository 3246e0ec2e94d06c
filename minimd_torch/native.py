"""The host runtime (csrc/native.cpp) through ctypes: the atom-type
stream, the FCC lattice with its velocities, and the LAMMPS data reader.

The counterpart of the JAX package's native module, on the port's own
copy of the C++ source, built by `_build.build_host()` at first use.
There is no fallback: a missing compiler or a failed build raises. The
arrays equal the numpy bodies' (`create.create_atoms_plain`,
`create.assign_types_plain`, `lammps_data.read_lammps_data_plain`) bit
for bit.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from . import _build

# the reader's error codes (csrc/native.cpp)
_READ_ERRORS = {
    -2: "an atom id outside 1..natoms",
    -3: "a row with fewer columns than its section needs",
    -4: "a column that is not a number",
    -5: "no Atoms section found",
    -6: "natoms changed between the header and the sections",
}


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def rand_types(seed: int, n: int, ntypes: int) -> np.ndarray:
    """n draws of glibc rand() % ntypes after srand(seed), int32 (n,)."""
    if ntypes < 1:
        raise ValueError(f"ntypes {ntypes}: at least 1")
    out = np.empty(n, np.int32)
    _build.host_lib().mmd_rand_types(seed, n, ntypes, _ptr(out))
    return out


def create_atoms(nx: int, ny: int, nz: int, rho: float,
                 bounds) -> tuple[np.ndarray, np.ndarray]:
    """The FCC sites inside bounds (xlo, xhi, ylo, yhi, zlo, zhi) in the
    reference's order and their Park-Miller velocities: float64 (n, 3)
    each."""
    if not rho > 0:
        raise ValueError(f"density {rho}: must be positive")
    if (2 * nx) * (2 * ny) * (2 * nz) >= 2 ** 31:
        raise ValueError(f"{nx}x{ny}x{nz} unit cells: the site seeds pass "
                         "the reference's 32-bit int")
    b = np.ascontiguousarray(bounds, dtype=np.float64)
    if b.shape != (6,):
        raise ValueError(f"bounds: 6 values, got shape {b.shape}")
    cap = 4 * nx * ny * nz + 8
    x = np.empty((cap, 3), np.float64)
    v = np.empty((cap, 3), np.float64)
    n = _build.host_lib().mmd_create_atoms(nx, ny, nz, rho, _ptr(b), cap,
                                           _ptr(x), _ptr(v))
    if n < 0:
        raise RuntimeError(f"create_atoms: more than {cap} sites")
    return x[:n].copy(), v[:n].copy()


def read_lammps_data(path) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                    float]:
    """(box (3,) = xhi - xlo, yhi - ylo, zhi - zlo; x (n, 3); v (n, 3);
    mass), all float64; rows placed by their 1-based ids. Raises
    FileNotFoundError for a file it cannot open and ValueError for an id
    outside 1..natoms, a short row or a column that is not a number."""
    lib = _build.host_lib()
    name = str(pathlib.Path(path)).encode()
    line = ctypes.c_int64(0)
    box = np.zeros(3, np.float64)
    mass = np.ones(1, np.float64)
    n = lib.mmd_read_lammps_data(name, 0, None, None, None, None,
                                 ctypes.byref(line))
    if n >= 0:
        x = np.zeros((n, 3), np.float64)
        v = np.zeros((n, 3), np.float64)
        n = lib.mmd_read_lammps_data(name, len(x), _ptr(box), _ptr(mass),
                                     _ptr(x), _ptr(v), ctypes.byref(line))
    if n == -1:
        raise FileNotFoundError(path)
    if n < 0:
        at = f" (line {line.value})" if line.value else ""
        raise ValueError(f"{path}{at}: {_READ_ERRORS[n]}")
    return box, x, v, float(mass[0])
